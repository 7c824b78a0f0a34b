#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc)::

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the script with a non-zero exit
code and without the final line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is turned off for matmuls and cuDNN.
2. build: every kernel under morgana_tpu_torch/csrc, built from source, and
   the step_split build of K1 and K2 (their per-step clock records).
   vocoder_native: the vocoder's world_synth.cpp built by g++ and loaded
   (its build seconds), and 5 s of a vowel through it and through the NumPy
   path, held to each other; host ms a second of audio for each.
   k1_step_split / k2_step_split: where a step of K1 (B16, B32, and B16
   with bf16 storage) and K2 (B32) goes at H=512, T=1024.
3. kernel K1 (the LSTM layer recurrence) against its plain PyTorch version
   and against torch.nn.LSTM (cuDNN, a yardstick the port never calls), at
   H=512, ragged seq_len, with and without an initial state, B up to 256;
   times; then K1 built for bf16 storage (K1s) against the plain version
   with the same storage.
4. k2: the gradient path of the LSTM layer, K1 writing its gate trace and
   K2 (the backward), against autograd through the plain recurrence, for a
   loss on y, hn and cn under ragged seq_len; the gate trace against the
   plain gates; times of K2, of K1 with and without the gate trace, and of
   one torch.nn.LSTM forward+backward (cuDNN) beside the port's layer; then
   the same with bf16 storage.
5. serving: LSTMAcousticModel at full width (609 inputs, 8 x LSTM(512),
   199 outputs) with seeded weights and normaliser statistics, served by
   InferenceEngine.predict_items on 32 utterances of 200-1000 frames; checks
   shapes, finiteness, K1's launch count and agreement with the same engine
   on the CPU; throughput, peak memory and where a batch's time goes.
   vocoder_batch: the batched vocoder (torch_world.synthesize_batch) on the
   card at B16, T=1000, on the 16 longest served utterances' features and on
   seeded vowels of the same lengths: two card runs bit-identical, each row
   against the same call on the CPU and the float64 host path; card ms,
   real-time factor, peak memory. generate_lstm: the same checkpoint and
   utterances, written as a corpus split, through
   InferenceEngine.generate (32 wavs, 8 K1 launches a batch, one wav against
   the CPU engine's); utt/s, frames/s, audio seconds/s and the split of the
   seconds (load, predict, D2H, vocoder, writes); then the serving command
   line once.
6. train: the same model trained at full width by the port's
   ExperimentBuilder with the JAX package's defaults (B=32, Adam, lr 0.01,
   constant schedule) for 2 epochs with validation, on a synthetic corpus of
   64 + 16 utterances of about 200-1000 frames, from a seeded epoch_0.npz;
   checks finite losses and metrics, 8 launches each of K1-with-gates and
   K2 per train step, K1 without gates in validation, the outputs and the
   checkpoint's strict reload; ms per step, frames/s, peak memory and where
   a step's time goes. builder_test: the builder's --test without training
   on that epoch_2.npz (the corpus's 16 valid utterances as its test set):
   one wav each in test/epoch_2/synth, 8 K1 launches a batch. serve_bf16
   and train_bf16: phases 5 and 6 again with
   rnn_backend='pallas' and bf16 storage (MORGANA_PALLAS_STORE=bfloat16),
   every K1 and K2 launch the bf16 build.
7. train_parity: the same trainer on the GPU and on the CPU (plain
   versions) from the same init and data, 3 steps of B=4 at full width:
   per-step losses and the first step's gradients.
8. k3: kernel K3 (the GRU layer recurrence) against its plain version and
   against torch.nn.GRU (cuDNN, a yardstick the port never calls), at H=64
   (B=32 and B=16, T=1024) and H=128 (B=32, T=128), ragged seq_len, with
   and without an initial state, and at edge shapes (T=0, T=1, B=1, 5, 40,
   256); times, per step beside cuDNN's.
9. k4: the gradient path of the GRU layer (K3, then K4, the backward)
   against autograd through the plain recurrence, for a loss on y and hn
   under ragged seq_len; K4 alone on the layer's operands, fed hg from its
   GEMM, against its plain version; times of K4, of the hg GEMM, of the layer forward+backward and
   of torch.nn.GRU forward+backward (cuDNN: the weights' gradients, and all
   gradients). Then gru_step_sweep: K3's and K4's us per step at T=1024,
   H 32/64/128, B 1/16/32.
10. f0_serving: F0Model at full width (609 inputs, 3 x GRU(64), 3 outputs)
    with seeded weights and normaliser statistics, served by
    InferenceEngine.predict_items on 32 utterances of 200-1000 frames at
    B=16; checks shapes, finiteness, 3 K3 launches per batch and agreement
    with the same engine on the CPU; throughput and peak memory.
11. f0_train: F0Model trained by the ExperimentBuilder (B=32, the JAX
    defaults but --valid_output_interval 1) for 2 epochs with validation
    on the train phase's corpus, from a seeded epoch_0.npz; checks finite
    losses and metrics, 3 launches each of K3 and K4 per train step, K3
    alone in validation and the checkpoint's strict reload; ms per step,
    frames/s, peak memory and where a step's time goes. f0_valid_synth: its
    validation analysis wrote one wav per valid utterance each epoch.
12. f0_train_parity: as train_parity, for F0Model.
13. duration_train: DurationModel (GRU(128)) trained for 2 epochs with its
    validation analysis every epoch; checks 1 launch each of K3 and K4 per
    train step and the feats/dur/*.npy it writes; ms per step and where a
    step's time goes.
14. k5: the attention forward kernel (K5/K6) against its plain version on
    the rows below seq_len, at H=4, T=1024 and ragged seq_len: dh 96 at B=16
    and B=32 (full, causal, causal with window 256), dh 64 and 128, and edge
    shapes (T=1, T=77, B=1, rows of length 0, padded rows past a window);
    times against the bound on the tensor cores in 3xTF32 (and the bound
    on the f32 CUDA cores, simt_bound_ms) and against torch's
    scaled_dot_product_attention (a yardstick the port never calls). k6:
    MultiHeadAttention(backend='flash') at the model's width against the
    plain attention.
15. k5_bwd: the attention backward (forward, then backward kernel) against
    autograd through the plain version, for a loss on the valid rows, at the
    same shapes; times of the backward, of the plain version's backward and
    of one SDPA forward+backward.
16. transformer_serving: TransformerAcousticModel at its defaults (609 ->
    384, 6 blocks of 4 heads of 96, d_ff 1536, 199 outputs) served as in
    f0_serving; 6 attention launches per batch.
17. transformer_train: the same model trained for 2 epochs with validation
    at lr 0.001 (B=32); 6 forward and 6 backward attention launches per train
    step, 6 forward per valid batch; ms per step and where it goes.
18. transformer_train_parity: as train_parity, for the Transformer.
19. transformer_dropout: TransformerAcousticModel(dropout_prob=0.1) trained
    for 1 epoch with validation: no attention kernel launched in its train
    steps (probability dropout takes the exact plain path, as in the JAX
    package), the forward kernel in validation; finite losses.

Then a line {"kernels": [...]} with each kernel's numbers at its main
path's shape, the nvidia-smi line, and last {"ok": true, "device": {...}}.
The vocoder holds no kernel (the JAX package's is plain XLA), so it has no
entry there; its phases' lines carry the card's name and power limit.
Needs no network and writes only to a temporary directory. The profiler's
device-time tables go to stderr.

Two other modes, each after the device and build phases: --attention-parent
DIR times the attention kernels of another tree (DIR holds its
morgana_tpu_torch/csrc, e.g. a git archive of the parent commit) beside this
tree's, in turns, at the k5 / k5_bwd main shapes (attn_parent_compare);
--transformer-only runs phases 16 and 17 alone: copied into another tree's
root, it gives that tree's end-to-end numbers.
"""
import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H = 512
F32_PEAK_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
TF32_PEAK_FLOPS = 495e12    # H100 SXM, TF32 tensor cores, dense
# exp2 on the special-function units: 16 a clock an SM (compute capability
# 9.0), 132 SMs at the 1.83 GHz of the published tensor-core peaks.
SFU_EXP_PER_S = 16 * 132 * 1.83e9
BF16_PEAK_FLOPS = 989e12    # H100 SXM, bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
KERNEL_TOL = 1e-4           # K1 vs plain and vs cuDNN, f32, abs; also the gate trace
# bf16 storage (MORGANA_PALLAS_STORE=bfloat16): kernel and plain version sum
# in f32 in other orders, so a stored value may round to the other bf16
# neighbour and carry that through the chain. Each tensor within BF16_ULPS
# units in the last place of bf16 (2**-7 relative at most) at its largest
# |value|. And the kernel's mean |error| at least BF16_CLOSER times smaller
# against that plain version than against the plain version with f32
# storage on the same bf16 inputs (outputs rounded to bf16): a kernel that
# skipped the rounding of h or of the gate gradients before a product would
# sit near the second. On the H100 a sound kernel is 3.7-4.6x closer at
# T=1024 (a flipped neighbour carries through the f32 cell state), 10x and
# more on short chains; K2 built without the rounding of the gate gradients
# was 4000x further, and passed the ulp bound. The network outputs of the
# bf16 serving phase within BF16_NET_TOL abs of the CPU engine with the same
# storage, trajectories relative (1.41e-5 at most in six runs), and closer
# to it in mean than the same GPU engine with f32 storage is. The outputs
# barely tell the storage types apart (the control's max error 2.13e-5,
# its mean 1.5x the bf16 engine's), so the kernel cases hold the rounding.
BF16_ULPS = 4
BF16_CLOSER = 2
BF16_NET_TOL = 3e-5
NET_TOL = 1e-4              # network outputs, GPU engine vs CPU engine, abs
TRAJ_RTOL = 1e-3            # MLPG trajectories, GPU vs CPU, relative to max |value|
# Gradients of the kernel path vs autograd through the plain loop, each
# relative to its tensor's max |value|: f32 sums in other orders, over up to
# 1024 steps, and dW_hh sums T * B terms.
GRAD_RTOL = 1e-3
# GPU trainer vs CPU trainer: per-step losses (relative) and the first
# step's gradients (relative to each parameter's max |grad|).
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_RTOL = 1e-3
SERVE_BATCH = 16
N_UTTS = 32
TRAIN_BATCH = 32
F0_LAYERS = 3       # F0Model: 3 x GRU(64)
TRANSFORMER_BLOCKS = 6      # TransformerAcousticModel's defaults
TRANSFORMER_LR = '0.001'    # the learning rate its JAX docstring recommends
# The vocoder: 16 kHz, 5 ms frames. Float32 paths (card, CPU, JAX) against
# each other: relative L2 within VOCODER_RTOL where no glottal pulse may
# differ (unvoiced, or the same pulse train; the CPU tests measure 1.2e-6
# against JAX); voiced rows whose pulse trains differ by a sample (a phase
# crossing in an ulp gap), energy and peak within VOICED_RATIO_TOL. Against
# the float64 host path: unvoiced within HOST_VOCODER_RTOL (6.4e-7 on the
# CPU), voiced energy and peak. The native library against the NumPy path:
# each draws its own noise, so NATIVE_RTOL on a nearly periodic vowel (its
# aperiodic part about e^-8 of the amplitude; 5.0e-4 on the sandbox's CPU).
FS = 16000
HOP = 80
VOCODER_T = 1000
VOCODER_RTOL = 1e-5
VOICED_RATIO_TOL = 1e-4
HOST_VOCODER_RTOL = 1e-3
NATIVE_RTOL = 2e-3
# vocoder_batch's vowels: VOWEL_F0 + 10 * row Hz with an 8 Hz vibrato of 40
# frames. With f0 a multiple of 20 Hz each whole vibrato period ends on an
# integer phase exactly at a frame boundary, a tie that the float32 and
# float64 paths break on opposite sides (either is right): 12-25 pulses a
# row one sample apart at T = 1000, energy 1.5e-4-1.9e-4 apart (first chip
# run of this script's vocoder phases, H100; the same on the CPU).
VOWEL_F0 = 103.7
# The acoustic models' served outputs and their widths.
ACOUSTIC_DIMS = {'normalised_lf0_deltas': 3, 'normalised_mcep_deltas': 180,
                 'normalised_bap_deltas': 15, 'lf0': 1, 'vuv': 1, 'mcep': 60, 'bap': 5}


def emit(obj):
    print(json.dumps(obj), flush=True)


def max_abs(t):
    """max |t|, 0 for an empty tensor (T = 0)."""
    return float(t.abs().max()) if t.numel() else 0.0


def nvidia_smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_tol(want):
    """BF16_ULPS units in the last place of bf16 at want's largest |value|."""
    return BF16_ULPS * 2.0 ** -7 * max_abs(want.float())


def mean_abs_err(pairs):
    """Mean |a - b| over every element of the (a, b) pairs, in f32."""
    pairs = list(pairs)
    total = sum(float((a.float() - b.float()).abs().sum()) for a, b in pairs)
    return total / max(sum(a.numel() for a, _ in pairs), 1)


def closer(got, want, control):
    """(mean |got - want|, mean |got - control|, whether the first is at
    least BF16_CLOSER times smaller and the second not 0), over lists of
    tensors."""
    near, far = mean_abs_err(zip(got, want)), mean_abs_err(zip(got, control))
    return near, far, far > 0 and near * BF16_CLOSER <= far


def k1_bound(batch, time_steps, hidden, gates=False, store=None):
    """Least time for the recurrence: 2*B*H*4H flops per step against the
    peak of the inputs' type (f32, or bf16's tensor-core rate with bf16
    storage), and xg read plus y and c_all written (with w_hh read; with
    `gates`, g_all (T, B, 4H) written too) in the storage type, h0, c0 read
    and hn, cn written in f32, against the memory rate."""
    size, peak = (2, BF16_PEAK_FLOPS) if store == 'bfloat16' else (4, F32_PEAK_FLOPS)
    flops = 2.0 * batch * hidden * 4 * hidden * time_steps
    nbytes = size * ((2 if gates else 1) * time_steps * batch * 4 * hidden
                     + 2 * time_steps * batch * hidden + hidden * 4 * hidden) \
        + 4.0 * 4 * batch * hidden
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def k2_bound(batch, time_steps, hidden, store=None):
    """Least time for the backward recurrence: 2*B*4H*H flops per step
    (dh = dxg @ w_hh^T) against the peak of the inputs' type, and g_all read
    plus dxg written, c_all, dy and dc_all read (with w_hh and c0 read) in
    the storage type, dhn, dcn read and dh0, dc0 written in f32, against the
    memory rate."""
    size, peak = (2, BF16_PEAK_FLOPS) if store == 'bfloat16' else (4, F32_PEAK_FLOPS)
    flops = 2.0 * batch * 4 * hidden * hidden * time_steps
    nbytes = size * (2 * time_steps * batch * 4 * hidden + 3 * time_steps * batch * hidden
                     + hidden * 4 * hidden + batch * hidden) + 4.0 * 4 * batch * hidden
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def k3_bound(batch, time_steps, hidden):
    """Least time for the GRU recurrence: 2*B*H*3H flops per step against the
    float32 peak, and xg (T, B, 3H) read plus y written (with w_hh, b_hh and
    h0 read and hn written) against the memory rate."""
    flops = 2.0 * batch * hidden * 3 * hidden * time_steps
    nbytes = 4.0 * (time_steps * batch * 3 * hidden + time_steps * batch * hidden
                    + hidden * 3 * hidden + 3 * hidden + 2 * batch * hidden)
    ops_ms, bytes_ms = flops / F32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def k4_bound(batch, time_steps, hidden):
    """Least time for the GRU backward recurrence given hg: one product of
    2*B*3H*H flops per step (the carry through w_hh^T) against the float32
    peak, and xg and hg read plus dxg written, y and dy read plus dnr
    (da_n * r) written (with w_hh, h0 and dhn read and dh0 written) against
    the memory rate. The hg GEMM is timed apart (hg_gemm_ms)."""
    flops = 2.0 * batch * hidden * 3 * hidden * time_steps
    nbytes = 4.0 * (3 * time_steps * batch * 3 * hidden + 3 * time_steps * batch * hidden
                    + hidden * 3 * hidden + 3 * batch * hidden)
    ops_ms, bytes_ms = flops / F32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def layer_inputs(torch, dev, batch, time_steps, with_state, seed):
    """Seeded inputs of one LSTM(512) layer: x, the four weights, a ragged
    seq_len (one row of T, one of 1) and an optional initial state."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / math.sqrt(H)

    def uniform(*shape):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32)).to(dev)

    x = torch.from_numpy(rng.normal(size=(batch, time_steps, H)).astype(np.float32)).to(dev)
    weights = [uniform(H, 4 * H), uniform(H, 4 * H), uniform(4 * H), uniform(4 * H)]
    seq_len = rng.integers(1, time_steps + 1, batch)
    seq_len[0] = time_steps
    seq_len[-1] = 1
    seq_len = torch.from_numpy(seq_len).to(dev)
    h0 = c0 = None
    if with_state:
        h0 = torch.from_numpy(0.5 * rng.normal(size=(batch, H)).astype(np.float32)).to(dev)
        c0 = torch.from_numpy(0.5 * rng.normal(size=(batch, H)).astype(np.float32)).to(dev)
    return x, weights, seq_len, h0, c0


def k1_case(torch, dev, batch, time_steps, with_state, seed, timed, store=None):
    """K1 through lstm_layer (no gradient) against the plain layer, f32
    within KERNEL_TOL abs and also against cuDNN; with `store` 'bfloat16'
    (the K1s variant) each output within bf16_tol of the plain layer with the
    same storage, cuDNN's f32 error only reported, and the recurrence
    BF16_CLOSER times closer to its bf16 plain version than to the f32
    storage one (closer()). With `timed`, the times of
    K1 alone, its plain version, the layer and cuDNN (in bf16 with bf16
    storage), and the bound."""
    from morgana_tpu_torch.ops import lstm as lstm_ops

    x, (w_ih, w_hh, b_ih, b_hh), seq_len, h0, c0 = layer_inputs(
        torch, dev, batch, time_steps, with_state, seed)
    cudnn = cudnn_layer(torch, dev, w_ih, w_hh, b_ih, b_hh)
    bf16 = store == 'bfloat16'

    with torch.inference_mode():
        before = (lstm_ops.launches, lstm_ops.bf16_launches)
        y_k, (hn_k, cn_k) = lstm_ops.lstm_layer(x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0,
                                                store_dtype=store)
        torch.cuda.synchronize()
        launched = (lstm_ops.launches - before[0], lstm_ops.bf16_launches - before[1])
        y_p, (hn_p, cn_p) = lstm_ops.lstm_layer_reference(x, w_ih, w_hh, b_ih, b_hh, seq_len, h0,
                                                          c0, store_dtype=store)
        pairs = ((y_k, y_p), (hn_k, hn_p), (cn_k, cn_p))
        err_plain = max(max_abs(a - b) for a, b in pairs)
        within = all(max_abs(a - b) <= (bf16_tol(b) if bf16 else KERNEL_TOL) for a, b in pairs)

        hx = None if h0 is None else (h0[None].contiguous(), c0[None].contiguous())
        y_c, _ = cudnn(x, hx)
        mask = (torch.arange(time_steps, device=dev)[None, :] < seq_len[:, None])[:, :, None]
        hn_c = torch.gather(y_c, 1, (seq_len - 1)[:, None, None].expand(batch, 1, H))[:, 0]
        err_cudnn = max(float((y_k - y_c * mask).abs().max()), float((hn_k - hn_c).abs().max()))

        out = {'phase': 'k1', 'store': store or 'float32', 'B': batch, 'T': time_steps, 'H': H,
               'initial_state': with_state, 'seq_len_min': int(seq_len.min()),
               'seq_len_max': int(seq_len.max()), 'max_abs_err_vs_plain': err_plain,
               'max_abs_err_vs_cudnn_f32': err_cudnn,
               'tolerance': f'{BF16_ULPS} bf16 ulps at each output\'s max' if bf16 else KERNEL_TOL,
               'within_tolerance': within, 'launches': launched[0],
               'bf16_launches': launched[1]}
        dtype = torch.bfloat16 if bf16 else torch.float32
        xg = (torch.matmul(x, w_ih) + (b_ih + b_hh)).transpose(0, 1).contiguous().to(dtype)
        w_s = w_hh.to(dtype)
        zeros = torch.zeros((batch, H), device=dev)
        hs, cs = (zeros, zeros) if h0 is None else (h0, c0)
        if bf16:   # y, c_all, hn, cn of the recurrence on the same bf16 inputs
            got = lstm_ops.lstm_recurrence(xg, w_s, hs, cs)
            want = lstm_ops.lstm_recurrence_reference(xg, w_s, hs, cs)
            f32 = lstm_ops.lstm_recurrence_reference(xg.float(), w_s.float(), hs, cs)
            control = (f32[0].to(dtype), f32[1].to(dtype), f32[3], f32[4])
            pick = (0, 1, 3, 4)
            out['mean_err_vs_plain'], out['mean_err_vs_f32_storage'], closer_ok = closer(
                [got[i] for i in pick], [want[i] for i in pick], control)
            out['within_tolerance'] = within = within and closer_ok
        if timed:
            out['kernel_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_recurrence(xg, w_s, hs, cs), 20)
            out['plain_ms'] = cuda_ms(
                torch, lambda: lstm_ops.lstm_recurrence_reference(xg, w_s, hs, cs), 2)
            out['layer_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_layer(
                x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0, store_dtype=store), 20)
            if bf16:   # cuDNN with its weights, input and state in bf16
                cudnn, x_l = cudnn.to(dtype), x.to(dtype)
                hx = None if hx is None else tuple(t.to(dtype) for t in hx)
            else:
                x_l = x
            out['library_ms'] = cuda_ms(torch, lambda: cudnn(x_l, hx), 20)
            out['bound_ms'], out['bound_by'] = k1_bound(batch, time_steps, H, store=store)
            out['us_per_step'] = out['kernel_ms'] * 1e3 / time_steps
    emit(out)
    if not (within and (bf16 or err_cudnn <= KERNEL_TOL) and launched == (1, int(bf16))):
        raise AssertionError(f'K1 disagrees at B={batch} T={time_steps}: {out}')
    return out


def cudnn_layer(torch, dev, w_ih, w_hh, b_ih, b_hh):
    """torch.nn.LSTM (cuDNN) holding the same weights: the yardstick."""
    cudnn = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_ih.t())
        cudnn.weight_hh_l0.copy_(w_hh.t())
        cudnn.bias_ih_l0.copy_(b_ih)
        cudnn.bias_hh_l0.copy_(b_hh)
    return cudnn


def layer_grads(torch, layer, x, weights, seq_len, h0, c0, loss_weights):
    """Gradients of sum(y*wy) + sum(hn*wh) + sum(cn*wc) with respect to x,
    the four weights, h0 and c0 (zeros given when there is no state)."""
    batch = x.shape[0]
    h0 = torch.zeros((batch, H), device=x.device) if h0 is None else h0
    c0 = torch.zeros((batch, H), device=x.device) if c0 is None else c0
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *weights, h0, c0)]
    y, (hn, cn) = layer(*leaves[:5], seq_len=seq_len, h0=leaves[5], c0=leaves[6])
    loss = sum((out * w).sum() for out, w in zip((y, hn, cn), loss_weights))
    return torch.autograd.grad(loss, leaves)


def k2_case(torch, dev, batch, time_steps, with_state, seed, timed, store=None):
    """The gradient path (K1 with gates, then K2) against autograd through
    the plain recurrence (with `store` 'bfloat16', the plain versions in the
    same autograd Function), each gradient relative to its max |value|; the
    gate trace against the plain gates; K2 alone against its plain version
    on the same saved tensors. f32 within GRAD_RTOL (the gate trace
    KERNEL_TOL abs), bf16 within BF16_ULPS bf16 ulps, and BF16_CLOSER times
    closer (closer()) to the bf16 plain versions than to the f32 ones: the
    layer's gradients to autograd through the f32 plain layer, K2's outputs
    to its plain version on the same inputs in f32. With `timed`, the
    times of K2, of K1 with and without gates, and of a layer
    forward+backward beside cuDNN's."""
    from morgana_tpu_torch.ops import lstm as lstm_ops

    bf16 = store == 'bfloat16'
    dtype = torch.bfloat16 if bf16 else torch.float32
    rtol = BF16_ULPS * 2.0 ** -7 if bf16 else GRAD_RTOL
    x, weights, seq_len, h0, c0 = layer_inputs(torch, dev, batch, time_steps, with_state, seed)
    rng = np.random.default_rng(seed + 100)
    loss_weights = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                    for shape in ((batch, time_steps, H), (batch, H), (batch, H))]
    names = ('dx', 'dw_ih', 'dw_hh', 'db_ih', 'db_hh', 'dh0', 'dc0')

    def layer(reference):
        fn = lstm_ops.lstm_layer_reference if reference else lstm_ops.lstm_layer
        return lambda *a, **k: fn(*a, store_dtype=store, **k)

    counts = ('gate_launches', 'bwd_launches', 'bf16_launches', 'bf16_bwd_launches')
    before = [getattr(lstm_ops, c) for c in counts]
    got = layer_grads(torch, layer(False), x, weights, seq_len, h0, c0, loss_weights)
    torch.cuda.synchronize()
    launched = tuple(getattr(lstm_ops, c) - b for c, b in zip(counts, before))
    want = layer_grads(torch, layer(True), x, weights, seq_len, h0, c0, loss_weights)
    grad_rel = {n: float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for n, g, w in zip(names, got, want)}

    w_ih, w_hh, b_ih, b_hh = weights
    zeros = torch.zeros((batch, H), device=dev)
    hs, cs = (zeros, zeros) if h0 is None else (h0, c0)
    xg = (torch.matmul(x, w_ih) + (b_ih + b_hh)).transpose(0, 1).contiguous().to(dtype)
    w_s = w_hh.to(dtype)
    _, c_all, g_kernel, _, _ = lstm_ops.lstm_recurrence(xg, w_s, hs, cs, with_gates=True)
    _, _, g_plain, _, _ = lstm_ops.lstm_recurrence_reference(xg, w_s, hs, cs)
    gate_err = max_abs(g_kernel.float() - g_plain.float())
    gate_tol = bf16_tol(g_plain) if bf16 else KERNEL_TOL

    # K2 alone against its plain version on the same saved tensors.
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
           for shape in ((time_steps, batch, H), (time_steps, batch, H), (batch, H), (batch, H))]
    bwd_args = (g_kernel, w_s, cs.to(dtype), c_all, cot[0].to(dtype), cot[1].to(dtype), *cot[2:])
    dxg_k = lstm_ops.lstm_backward(*bwd_args)
    dxg_p = lstm_ops.lstm_backward_reference(*bwd_args)
    k2_err = max(max_abs(a.float() - b.float()) for a, b in zip(dxg_k, dxg_p))
    k2_rel = max(max_abs(a.float() - b.float()) / max(max_abs(b.float()), 1e-30)
                 for a, b in zip(dxg_k, dxg_p))
    closer_ok = True
    if bf16:
        f32 = lstm_ops.lstm_backward_reference(*(a.float() for a in bwd_args))
        k2_closer = closer(dxg_k, dxg_p, (f32[0].to(dtype), f32[1], f32[2]))
        want_f32 = layer_grads(torch, lstm_ops.lstm_layer_reference, x, weights, seq_len, h0, c0,
                               loss_weights)
        grad_closer = {n: closer([g], [w], [o])
                       for n, g, w, o in zip(names, got, want, want_f32)}
        closer_ok = k2_closer[2] and all(c[2] for c in grad_closer.values())

    out = {'phase': 'k2', 'store': store or 'float32', 'B': batch, 'T': time_steps, 'H': H,
           'initial_state': with_state, 'grad_rel_err_vs_plain': grad_rel, 'grad_rtol': rtol,
           'gate_trace_max_abs_err': gate_err, 'gate_tol': gate_tol,
           'k2_max_abs_err': k2_err, 'k2_rel_err': k2_rel,
           'k1_gate_launches': launched[0], 'k2_launches': launched[1],
           'bf16_k1_launches': launched[2], 'bf16_k2_launches': launched[3]}
    if bf16:
        out['k2_mean_err_vs_plain'], out['k2_mean_err_vs_f32_storage'] = k2_closer[:2]
        out['grad_mean_err_vs_plain_and_f32'] = {n: c[:2] for n, c in grad_closer.items()}
    if timed:
        out['kernel_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_backward(*bwd_args), 10)
        out['plain_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_backward_reference(*bwd_args), 2)
        out['bound_ms'], out['bound_by'] = k2_bound(batch, time_steps, H, store=store)
        out['us_per_step'] = out['kernel_ms'] * 1e3 / time_steps
        out['k1_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_recurrence(xg, w_s, hs, cs), 10)
        out['k1_gates_ms'] = cuda_ms(
            torch, lambda: lstm_ops.lstm_recurrence(xg, w_s, hs, cs, with_gates=True), 10)
        out['k1_gates_bound_ms'], out['k1_gates_bound_by'] = k1_bound(batch, time_steps, H, True,
                                                                      store)
        out['layer_fwd_bwd_ms'] = cuda_ms(torch, lambda: layer_grads(
            torch, layer(False), x, weights, seq_len, h0, c0, loss_weights), 5)
        cudnn = cudnn_layer(torch, dev, *weights).to(dtype)
        hx = None if h0 is None else (h0[None].to(dtype).contiguous(),
                                      c0[None].to(dtype).contiguous())
        x_l, wy = x.to(dtype), loss_weights[0].to(dtype)

        def cudnn_fwd_bwd():
            y_c, _ = cudnn(x_l, hx)
            (y_c * wy).sum().backward()

        # cuDNN's backward cannot be timed alone: this includes its forward.
        out['library_ms'] = cuda_ms(torch, cudnn_fwd_bwd, 5)
    emit(out)
    if not (max(grad_rel.values()) <= rtol and gate_err <= gate_tol and k2_rel <= rtol
            and closer_ok and launched == (1, 1, int(bf16), int(bf16))):
        raise AssertionError(f'K1 with gates / K2 disagree at B={batch} T={time_steps}: {out}')
    return out


SPLIT_STEPS = 512           # steps of a launch whose phases the step_split build records
SPLIT_SKIP = 16             # first steps left out of the medians
SPLIT_PHASES = ('exchange', 'product', 'reduction', 'gates', 'barrier')


def read_split(torch, split, steps):
    """The records of a step_split launch: per recording block (block 0 and
    the middle one), each phase's median us a step over steps SPLIT_SKIP..
    and the mean step; cycles become us by the launch's clock64 and
    globaltimer deltas."""
    rec = split.cpu().double().view(2, -1)
    n = len(SPLIT_PHASES)
    blocks = {}
    for slot, name in enumerate(('block_0', 'block_middle')):
        cycles = rec[slot, :steps * n].view(steps, n)[SPLIT_SKIP:]
        c_start, ns_start, c_end, ns_end = rec[slot, steps * n:].tolist()
        us_per_cycle = (ns_end - ns_start) / (c_end - c_start) / 1e3
        medians = (cycles.median(dim=0).values * us_per_cycle).tolist()
        blocks[name] = dict({f'{p}_us': v for p, v in zip(SPLIT_PHASES, medians)},
                            mean_step_us=float(cycles.sum(dim=1).mean()) * us_per_cycle,
                            sm_clock_ghz=(c_end - c_start) / (ns_end - ns_start))
    return blocks


def lstm_step_split_phase(torch, dev):
    """k1_step_split (B16 and B32 in f32, B16 with bf16 storage, without the
    gate trace) and k2_step_split (B32) at H=512, T=1024: the step_split
    build of K1 and K2 records the phases of their first SPLIT_STEPS steps in
    block 0 and the middle block."""
    from morgana_tpu_torch.ops import lstm as lstm_ops

    steps = 1024
    split = torch.zeros(2 * (SPLIT_STEPS * len(SPLIT_PHASES) + 4), dtype=torch.int64, device=dev)
    for batch, store in ((SERVE_BATCH, None), (TRAIN_BATCH, None), (SERVE_BATCH, 'bfloat16')):
        x, (w_ih, w_hh, b_ih, b_hh), _, _, _ = layer_inputs(torch, dev, batch, steps, False, 70)
        dtype = torch.bfloat16 if store else torch.float32
        xg = (torch.matmul(x, w_ih) + (b_ih + b_hh)).transpose(0, 1).contiguous()
        zeros = torch.zeros((batch, H), device=dev)
        for _ in range(2):   # the first launch builds and warms up
            split.zero_()
            lstm_ops._lstm_fwd_cuda(xg.to(dtype), w_hh.to(dtype), zeros, zeros, split=split)
            torch.cuda.synchronize()
        emit({'phase': 'k1_step_split', 'store': store or 'float32', 'B': batch, 'T': steps,
              'H': H, 'gates': False, 'steps_recorded': SPLIT_STEPS, 'skipped': SPLIT_SKIP,
              **read_split(torch, split, SPLIT_STEPS)})
        if batch == TRAIN_BATCH:
            b32 = xg, w_hh, zeros
    # K2 on the B32 layer's gate trace.
    xg, w_hh, zeros = b32
    _, c_all, g_all, _, _ = lstm_ops._lstm_fwd_cuda(xg, w_hh, zeros, zeros, with_gates=True)
    rng = np.random.default_rng(71)
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
           for shape in ((steps, TRAIN_BATCH, H), (steps, TRAIN_BATCH, H), (TRAIN_BATCH, H),
                         (TRAIN_BATCH, H))]
    for _ in range(2):
        split.zero_()
        lstm_ops._lstm_bwd_cuda(g_all, w_hh, zeros, c_all, *cot, split=split)
        torch.cuda.synchronize()
    emit({'phase': 'k2_step_split', 'store': 'float32', 'B': TRAIN_BATCH, 'T': steps,
          'H': H, 'steps_recorded': SPLIT_STEPS, 'skipped': SPLIT_SKIP,
          **read_split(torch, split, SPLIT_STEPS)})


def gru_inputs(torch, dev, batch, time_steps, hidden, in_dim, with_state, seed):
    """Seeded inputs of one GRU(hidden) layer fed by in_dim features: x, the
    four weights, a ragged seq_len (one row of T, one of 1, one of 0 when
    B > 2) and an optional h0."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / math.sqrt(hidden)

    def uniform(*shape):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32)).to(dev)

    x = torch.from_numpy(rng.normal(size=(batch, time_steps, in_dim)).astype(np.float32)).to(dev)
    weights = [uniform(in_dim, 3 * hidden), uniform(hidden, 3 * hidden), uniform(3 * hidden),
               uniform(3 * hidden)]
    seq_len = rng.integers(1, time_steps + 1, batch) if time_steps else np.zeros(batch, np.int64)
    seq_len[0] = time_steps
    seq_len[-1] = min(time_steps, 1)
    if batch > 2:
        seq_len[1] = 0
    seq_len = torch.from_numpy(seq_len).to(dev)
    h0 = None
    if with_state:
        h0 = torch.from_numpy(0.5 * rng.normal(size=(batch, hidden)).astype(np.float32)).to(dev)
    return x, weights, seq_len, h0


def cudnn_gru(torch, dev, w_ih, w_hh, b_ih, b_hh):
    """torch.nn.GRU (cuDNN, the same r, z, n form) holding the same weights:
    the yardstick."""
    in_dim, hidden = w_ih.shape[0], w_hh.shape[0]
    cudnn = torch.nn.GRU(in_dim, hidden, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_ih.t())
        cudnn.weight_hh_l0.copy_(w_hh.t())
        cudnn.bias_ih_l0.copy_(b_ih)
        cudnn.bias_hh_l0.copy_(b_hh)
    return cudnn


def k3_case(torch, dev, batch, time_steps, hidden, in_dim, with_state, seed, timed):
    """K3 through gru_layer (no gradient) against the plain layer and, for
    T > 0, cuDNN's GRU; with `timed`, the times of K3 alone as the layer
    launches it (batch-major, with seq_len), of its plain version, of the
    layer (input GEMM and K3) and of one cuDNN GRU forward (input GEMM
    included: the like-for-like comparison is layer_ms)."""
    from morgana_tpu_torch.ops import gru as gru_ops

    x, (w_ih, w_hh, b_ih, b_hh), seq_len, h0 = gru_inputs(
        torch, dev, batch, time_steps, hidden, in_dim, with_state, seed)
    args = (x, w_ih, w_hh, b_ih, b_hh, seq_len, h0)
    with torch.inference_mode():
        before = gru_ops.launches
        y_k, hn_k = gru_ops.gru_layer(*args)
        torch.cuda.synchronize()
        launched = gru_ops.launches - before
        y_p, hn_p = gru_ops.gru_layer_reference(*args)
        err_plain = max(max_abs(y_k - y_p), max_abs(hn_k - hn_p))
        err_cudnn = 0.0
        cudnn = cudnn_gru(torch, dev, w_ih, w_hh, b_ih, b_hh)
        hx = None if h0 is None else h0[None].contiguous()
        if time_steps:
            y_c, _ = cudnn(x, hx)
            mask = (torch.arange(time_steps, device=dev)[None, :] < seq_len[:, None])[:, :, None]
            err_cudnn = float((y_k - y_c * mask).abs().max())

        out = {'phase': 'k3', 'B': batch, 'T': time_steps, 'H': hidden, 'in_dim': in_dim,
               'initial_state': with_state, 'seq_len_min': int(seq_len.min()),
               'seq_len_max': int(seq_len.max()), 'max_abs_err_vs_plain': err_plain,
               'max_abs_err_vs_cudnn': err_cudnn, 'tolerance': KERNEL_TOL, 'k3_launches': launched}
        if timed:
            xg = torch.matmul(x, w_ih) + b_ih
            xg_t = xg.transpose(0, 1).contiguous()
            hs = torch.zeros((batch, hidden), device=dev) if h0 is None else h0
            out['kernel_ms'] = cuda_ms(
                torch, lambda: gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, hs, seq_len), 50)
            out['plain_ms'] = cuda_ms(
                torch, lambda: gru_ops.gru_recurrence_reference(xg_t, w_hh, b_hh, hs), 2)
            out['layer_ms'] = cuda_ms(torch, lambda: gru_ops.gru_layer(*args), 50)
            out['library_ms'] = cuda_ms(torch, lambda: cudnn(x, hx), 50)
            out['bound_ms'], out['bound_by'] = k3_bound(batch, time_steps, hidden)
            out['us_per_step'] = out['kernel_ms'] * 1e3 / time_steps
            # cuDNN's layer includes its input GEMM: per step it is an upper
            # bound on its recurrence's step.
            out['library_us_per_step'] = out['library_ms'] * 1e3 / time_steps
    emit(out)
    if not (err_plain <= KERNEL_TOL and err_cudnn <= KERNEL_TOL and launched == 1):
        raise AssertionError(f'K3 disagrees at B={batch} T={time_steps} H={hidden}: {out}')
    return out


def gru_layer_grads(torch, layer, x, weights, seq_len, h0, loss_weights):
    """Gradients of sum(y*wy) + sum(hn*wh) with respect to x, the four weights
    and h0 (zeros given when there is no state); zeros where the loss does
    not reach an input (x at T = 0)."""
    batch, hidden = x.shape[0], weights[1].shape[0]
    h0 = torch.zeros((batch, hidden), device=x.device) if h0 is None else h0
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *weights, h0)]
    y, hn = layer(*leaves[:5], seq_len=seq_len, h0=leaves[5])
    loss = sum((out * w).sum() for out, w in zip((y, hn), loss_weights))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(leaf) if g is None else g for g, leaf in zip(grads, leaves)]


def k4_case(torch, dev, batch, time_steps, hidden, in_dim, with_state, seed, timed):
    """The gradient path (K3, then K4) against autograd through the plain
    recurrence, each gradient relative to its max |value|; K4 alone, as the
    layer launches it (batch-major, with seq_len), against its plain
    version; with `timed`, the times of K4, of its plain version, of the
    layer forward+backward and of cuDNN's GRU forward+backward."""
    from morgana_tpu_torch.ops import gru as gru_ops

    x, weights, seq_len, h0 = gru_inputs(torch, dev, batch, time_steps, hidden, in_dim,
                                         with_state, seed)
    rng = np.random.default_rng(seed + 100)
    loss_weights = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                    for shape in ((batch, time_steps, hidden), (batch, hidden))]
    names = ('dx', 'dw_ih', 'dw_hh', 'db_ih', 'db_hh', 'dh0')

    before = (gru_ops.launches, gru_ops.bwd_launches)
    got = gru_layer_grads(torch, gru_ops.gru_layer, x, weights, seq_len, h0, loss_weights)
    torch.cuda.synchronize()
    launched = (gru_ops.launches - before[0], gru_ops.bwd_launches - before[1])
    want = gru_layer_grads(torch, gru_ops.gru_layer_reference, x, weights, seq_len, h0,
                           loss_weights)
    grad_rel = {n: max_abs(g - w) / max(max_abs(w), 1e-30) for n, g, w in zip(names, got, want)}

    # K4 alone, on the layer's operands (batch-major, seq_len), against its
    # plain version on the same saved tensors and hg: dxg, dnr and dh0.
    w_ih, w_hh, b_ih, b_hh = weights
    hs = torch.zeros((batch, hidden), device=dev) if h0 is None else h0
    xg = torch.matmul(x, w_ih) + b_ih
    y, _ = gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, hs, seq_len)
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
           for shape in ((batch, time_steps, hidden), (batch, hidden))]
    _, hg = gru_ops.hidden_gates(w_hh, b_hh, hs, y, batch_first=True)
    bwd_args = (xg, hg, w_hh, hs, y, *cot, seq_len)
    k4_out = gru_ops._gru_bwd_cuda(*bwd_args)
    plain_out = gru_ops.layer_backward_reference(*bwd_args)
    k4_err = max(max_abs(a - b) for a, b in zip(k4_out, plain_out))
    k4_rel = max(max_abs(a - b) / max(max_abs(b), 1e-30) for a, b in zip(k4_out, plain_out))

    out = {'phase': 'k4', 'B': batch, 'T': time_steps, 'H': hidden, 'in_dim': in_dim,
           'initial_state': with_state, 'grad_rel_err_vs_plain': grad_rel,
           'grad_rtol': GRAD_RTOL, 'k4_max_abs_err': k4_err, 'k4_rel_err': k4_rel,
           'k3_launches': launched[0], 'k4_launches': launched[1]}
    if timed:
        out['kernel_ms'] = cuda_ms(torch, lambda: gru_ops._gru_bwd_cuda(*bwd_args), 20)
        out['plain_ms'] = cuda_ms(torch, lambda: gru_ops.layer_backward_reference(*bwd_args), 2)
        out['bound_ms'], out['bound_by'] = k4_bound(batch, time_steps, hidden)
        out['us_per_step'] = out['kernel_ms'] * 1e3 / time_steps
        out['hg_gemm_ms'] = cuda_ms(
            torch, lambda: gru_ops.hidden_gates(w_hh, b_hh, hs, y, batch_first=True), 20)
        out['k3_ms'] = cuda_ms(
            torch, lambda: gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, hs, seq_len), 20)
        out['layer_fwd_bwd_ms'] = cuda_ms(torch, lambda: gru_layer_grads(
            torch, gru_ops.gru_layer, x, weights, seq_len, h0, loss_weights), 10)
        cudnn = cudnn_gru(torch, dev, *weights)
        hx = None if h0 is None else h0[None].contiguous()

        def cudnn_fwd_bwd():
            y_c, _ = cudnn(x, hx)
            (y_c * loss_weights[0]).sum().backward()

        def cudnn_all_grads():
            leaves = [x.detach().clone().requires_grad_(True),
                      hs[None].detach().clone().requires_grad_(True)]
            y_c, h_c = cudnn(*leaves)
            loss = (y_c * loss_weights[0]).sum() + (h_c[0] * loss_weights[1]).sum()
            return torch.autograd.grad(loss, leaves + list(cudnn.parameters()))

        # cuDNN's backward cannot be timed alone: both include its forward.
        # library_ms (the yardstick of earlier runs) gives the weights'
        # gradients only; library_all_grads_ms also dx and dh0 and reads hn,
        # as the port's layer_fwd_bwd_ms does.
        out['library_ms'] = cuda_ms(torch, cudnn_fwd_bwd, 10)
        out['library_all_grads_ms'] = cuda_ms(torch, cudnn_all_grads, 10)
        # The event times above include the host's launches; the device's
        # own busy time of one call of each, and its kernels, from the
        # profiler:
        for key, fn in (('layer_fwd_bwd', lambda: gru_layer_grads(
                torch, gru_ops.gru_layer, x, weights, seq_len, h0, loss_weights)),
                        ('library', cudnn_fwd_bwd)):
            profile = profile_step(torch, fn)
            out[f'{key}_device_ms'] = profile['device_busy_ms']
            out[f'{key}_kernels'] = profile['kernels_launched']
    emit(out)
    if not (max(grad_rel.values()) <= GRAD_RTOL and k4_err <= KERNEL_TOL
            and k4_rel <= GRAD_RTOL and launched == (1, 1)):
        raise AssertionError(f'K3 / K4 gradients disagree at B={batch} T={time_steps} '
                             f'H={hidden}: {out}')
    return out


def gru_step_sweep(torch, dev, seed):
    """Where K3's and K4's step goes: us per step of each kernel alone at
    T=1024 for H 32/64/128 and B 1/16/32 (batch-major, no seq_len), beside
    cuDNN's GRU forward per step (its input GEMM included)."""
    from morgana_tpu_torch.ops import gru as gru_ops

    rng = np.random.default_rng(seed)
    steps = 1024
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for hidden in (32, 64, 128):
        for batch in (1, 16, 32):
            x, (w_ih, w_hh, b_ih, b_hh), _, _ = gru_inputs(torch, dev, batch, steps, hidden,
                                                           hidden, False, seed)
            xg = torch.matmul(x, w_ih) + b_ih
            hs = torch.zeros((batch, hidden), device=dev)
            y, _ = gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, hs)
            _, hg = gru_ops.hidden_gates(w_hh, b_hh, hs, y, batch_first=True)
            dy = torch.from_numpy(rng.normal(size=(batch, steps, hidden)).astype(np.float32)).to(dev)
            bwd = (xg, hg, w_hh, hs, y, dy, hs)
            cudnn = cudnn_gru(torch, dev, w_ih, w_hh, b_ih, b_hh)
            with torch.inference_mode():
                k3 = cuda_ms(torch, lambda: gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, hs), 20)
                k4 = cuda_ms(torch, lambda: gru_ops._gru_bwd_cuda(*bwd), 20)
                lib = cuda_ms(torch, lambda: cudnn(x), 20)
            rows.append({'H': hidden, 'B': batch,
                         'k3_us_per_step': k3 * 1e3 / steps, 'k4_us_per_step': k4 * 1e3 / steps,
                         'library_fwd_us_per_step': lib * 1e3 / steps})
    emit({'phase': 'gru_step_sweep', 'T': steps, 'sms': sms, 'rows': rows})


def attention_pairs(seq_len, time_steps, heads, causal, window):
    """P, the (query, key) pairs the kernel computes on valid rows: for each
    batch row of length n, query i < n sees keys j < n, j <= i when causal,
    i - j < window with a window."""
    pairs = 0
    for n in (int(x) for x in seq_len):
        n = min(max(n, 0), time_steps)
        i = np.arange(n)
        if window:
            pairs += int(np.minimum(i + 1, window).sum())
        elif causal:
            pairs += n * (n + 1) // 2
        else:
            pairs += n * n
    return heads * pairs


def attention_bound(batch, heads, time_steps, head_dim, pairs, backward=False):
    """Least time for attention on the route the kernels take, the tensor
    cores in 3xTF32: 3 * 4 * P * dh flops forward (q.k and p.v) and 3 * 10 *
    P * dh backward (q.k and do.v again, then dv, dq and dk: the least work;
    the two-pass kernels recompute both logits products, 14 * P * dh) at the
    TF32 peak; P exp forward and 2 * P backward at the SFU rate; q, k, v read
    and o, lse written (backward: q, k, v, o, do, lse read and dq, dk, dv
    written) at the memory rate. Returns (bound_ms, bound_by, simt_bound_ms):
    the largest of the three, what sets it, and the bound the kernels' f32
    CUDA-core versions were held to (the flops once at the f32 peak, or the
    bytes)."""
    width = heads * head_dim
    flops = (10.0 if backward else 4.0) * pairs * head_dim
    nbytes = 4.0 * ((8 if backward else 4) * batch * time_steps * width + batch * heads * time_steps)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(3 * flops / TF32_PEAK_FLOPS, (2 if backward else 1) * pairs / SFU_EXP_PER_S) * 1e3
    simt_ms = max(flops / F32_PEAK_FLOPS * 1e3, bytes_ms)
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes'), simt_ms


def attention_inputs(torch, dev, batch, heads, time_steps, head_dim, seed, empty_row=False):
    """Seeded q, k, v (B, H, T, dh) and a ragged seq_len (the first row full,
    with `empty_row` the last of length 0)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(batch, heads, time_steps, head_dim))
                                .astype(np.float32)).to(dev) for _ in range(3))
    seq_len = rng.integers(1, time_steps + 1, batch)
    seq_len[0] = time_steps
    if empty_row:
        seq_len[-1] = 0
    return q, k, v, torch.from_numpy(seq_len).to(dev)


def valid_rows(torch, seq_len, time_steps):
    return (torch.arange(time_steps, device=seq_len.device)[None, :]
            < seq_len[:, None])[:, None, :, None]


def sdpa(torch, q, k, v, seq_len, causal, window):
    """torch's scaled_dot_product_attention with the same additive mask: the
    yardstick (the port never calls it)."""
    from morgana_tpu_torch.ops.flash_attention import attention_bias

    bias = attention_bias(seq_len, q.shape[2], causal, window, device=q.device)
    if bias is not None:
        bias = bias.expand(q.shape[0], 1, q.shape[2], q.shape[2]).contiguous()
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def k5_case(torch, dev, batch, heads, time_steps, head_dim, causal, window, seed, timed,
            empty_row=False):
    """The forward kernel through flash_attention (no gradient) against its
    plain version on the rows below seq_len; rows that see no key must be 0.
    With `timed`, the times of the kernel, its plain version and torch's
    SDPA, and the bound."""
    from morgana_tpu_torch.ops import flash_attention as fa

    q, k, v, seq_len = attention_inputs(torch, dev, batch, heads, time_steps, head_dim, seed,
                                        empty_row)
    mask = dict(seq_len=seq_len, causal=causal, window=window)
    with torch.inference_mode():
        before = fa.launches
        got = fa.flash_attention(q, k, v, **mask)
        torch.cuda.synchronize()
        launched = fa.launches - before
        want = fa.flash_attention_reference(q, k, v, **mask)
        valid = valid_rows(torch, seq_len, time_steps)
        err = max_abs((got - want) * valid)
        finite = bool(torch.isfinite(got).all())
        empty_zero = not empty_row or bool((got[-1] == 0).all())
        pairs = attention_pairs(seq_len.tolist(), time_steps, heads, causal, window)
        out = {'phase': 'k5', 'B': batch, 'H': heads, 'T': time_steps, 'dh': head_dim,
               'causal': causal, 'window': window, 'seq_len_min': int(seq_len.min()),
               'seq_len_max': int(seq_len.max()), 'visible_pairs': pairs,
               'max_abs_err_vs_plain': err, 'tolerance': KERNEL_TOL, 'finite': finite,
               'empty_row_zero': empty_zero, 'launches': launched}
        if timed:
            out['max_abs_err_sdpa_vs_plain'] = max_abs((sdpa(torch, q, k, v, **mask) - want) * valid)
            out['kernel_ms'] = cuda_ms(torch, lambda: fa.attention_forward(q, k, v, **mask), 20)
            out['plain_ms'] = cuda_ms(torch, lambda: fa.flash_attention_reference(q, k, v, **mask), 5)
            out['library_ms'] = cuda_ms(torch, lambda: sdpa(torch, q, k, v, **mask), 20)
            out['bound_ms'], out['bound_by'], out['simt_bound_ms'] = attention_bound(
                batch, heads, time_steps, head_dim, pairs)
    emit(out)
    if not (err <= KERNEL_TOL and finite and empty_zero and launched == 1):
        raise AssertionError(f'K5/K6 forward disagrees: {out}')
    return out


def k6_case(torch, dev, seed):
    """K6's entry point, MultiHeadAttention(backend='flash') at the model's
    width (E 384, 4 heads of 96, B16, T1024, ragged seq_len), against the
    same projections around the plain attention."""
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.ops import flash_attention as fa

    torch.manual_seed(seed)
    mha = nn.MultiHeadAttention(384, 4, backend='flash').to(dev).eval()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(SERVE_BATCH, 1024, 384)).astype(np.float32)).to(dev)
    seq_len = torch.from_numpy(rng.integers(200, 1025, SERVE_BATCH)).to(dev)
    with torch.inference_mode():
        before = fa.launches
        got = mha(x, seq_len=seq_len)
        torch.cuda.synchronize()
        launched = fa.launches - before
        q, k, v = (t.reshape(SERVE_BATCH, 1024, 4, 96).transpose(1, 2)
                   for t in mha.in_proj(x).split(384, dim=-1))
        o = fa.flash_attention_reference(q, k, v, seq_len=seq_len)
        want = mha.out_proj(o.transpose(1, 2).reshape(SERVE_BATCH, 1024, 384))
        valid = (torch.arange(1024, device=dev)[None, :] < seq_len[:, None])[..., None]
        err = max_abs((got - want) * valid)
    out = {'phase': 'k6', 'module': "MultiHeadAttention(384, 4, backend='flash')",
           'B': SERVE_BATCH, 'T': 1024, 'max_abs_err_vs_plain': err, 'tolerance': KERNEL_TOL,
           'launches': launched}
    emit(out)
    if not (err <= KERNEL_TOL and launched == 1):
        raise AssertionError(f"MultiHeadAttention(backend='flash') disagrees: {out}")
    return out


def k5_bwd_case(torch, dev, batch, heads, time_steps, head_dim, causal, window, seed, timed,
                empty_row=False):
    """dq, dk, dv of a loss on the rows below seq_len: the kernel path
    (forward, then backward) against autograd through the plain version,
    each relative to the largest |value| of the three; the backward alone
    on the kernel's o and lse, likewise. With `timed`, the times of the backward, of the plain
    version's backward (autograd over its saved graph) and of one SDPA
    forward+backward, and the bound."""
    from morgana_tpu_torch.ops import flash_attention as fa

    q, k, v, seq_len = attention_inputs(torch, dev, batch, heads, time_steps, head_dim, seed,
                                        empty_row)
    mask = dict(seq_len=seq_len, causal=causal, window=window)
    rng = np.random.default_rng(seed + 100)
    weight = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(dev)
    weight = weight * valid_rows(torch, seq_len, time_steps)

    def grads(fn, retain=False):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        loss = (fn(*leaves, **mask) * weight).sum()
        return leaves, loss, torch.autograd.grad(loss, leaves, retain_graph=retain)

    before = (fa.launches, fa.bwd_launches)
    _, _, got = grads(fa.flash_attention)
    torch.cuda.synchronize()
    launched = (fa.launches - before[0], fa.bwd_launches - before[1])
    leaves, loss, want = grads(fa.flash_attention_reference, retain=True)
    names = ('dq', 'dk', 'dv')
    # Relative to the largest |value| of the three: dq and dk are exactly 0
    # where every row sees one key (T = 1), and their rounding residue is
    # held to dv's scale there.
    scale = max(max(max_abs(w) for w in want), 1e-30)
    grad_rel = {n: max_abs(g - w) / scale for n, g, w in zip(names, got, want)}

    o, lse = fa.attention_forward(q, k, v, **mask)
    bwd = fa.attention_backward(q, k, v, o, lse, weight, **mask)
    bwd_err = max(max_abs(a - b) for a, b in zip(bwd, want))
    bwd_rel = bwd_err / scale
    pairs = attention_pairs(seq_len.tolist(), time_steps, heads, causal, window)
    out = {'phase': 'k5_bwd', 'B': batch, 'H': heads, 'T': time_steps, 'dh': head_dim,
           'causal': causal, 'window': window, 'visible_pairs': pairs,
           'grad_rel_err_vs_plain': grad_rel, 'grad_rtol': GRAD_RTOL,
           'bwd_max_abs_err': bwd_err, 'bwd_rel_err': bwd_rel, 'fwd_launches': launched[0], 'bwd_launches': launched[1]}
    if timed:
        out['kernel_ms'] = cuda_ms(torch, lambda: fa.attention_backward(q, k, v, o, lse, weight,
                                                                        **mask), 10)
        out['plain_ms'] = cuda_ms(torch, lambda: torch.autograd.grad(loss, leaves,
                                                                     retain_graph=True), 3)
        out['fwd_bwd_ms'] = cuda_ms(torch, lambda: grads(fa.flash_attention), 10)
        out['library_ms'] = cuda_ms(torch, lambda: grads(
            lambda *a, **m: sdpa(torch, *a, **m)), 10)
        out['bound_ms'], out['bound_by'], out['simt_bound_ms'] = attention_bound(
            batch, heads, time_steps, head_dim, pairs, backward=True)
    emit(out)
    if not (max(grad_rel.values()) <= GRAD_RTOL and bwd_rel <= GRAD_RTOL and launched == (1, 1)):
        raise AssertionError(f'K5/K6 gradients disagree: {out}')
    return out


@contextlib.contextmanager
def attention_kernels_of(entries):
    """The attention wrappers of ops/flash_attention.py launch the kernels
    of `entries` ({(name, entry, None): (lib, fn)}, as ops/_kernels.py keeps
    them) instead of this tree's while the context is open."""
    from morgana_tpu_torch.ops import _kernels

    saved = {key: _kernels._ENTRIES.get(key) for key in entries}
    _kernels._ENTRIES.update(entries)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                _kernels._ENTRIES.pop(key, None)
            else:
                _kernels._ENTRIES[key] = value


def build_parent_attention(parent):
    """The attention kernels of another tree (`parent` holds its
    morgana_tpu_torch/csrc, e.g. a git archive of the parent commit), built
    with this tree's nvcc flags into `parent`/build, one nvcc each, both
    started together, and bound with this tree's entry types (the C entries
    kept their signatures). Returns the entries for attention_kernels_of and
    the compiler's register and spill lines."""
    import ctypes

    from morgana_tpu_torch import _build
    from morgana_tpu_torch.ops import _kernels

    csrc = os.path.join(parent, 'morgana_tpu_torch', 'csrc')
    out_dir = os.path.join(parent, 'build')
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ('attn_fwd', 'attn_bwd'):
        target = os.path.join(out_dir, f'{name}.so')
        procs[name] = target, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', target, os.path.join(csrc, f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries, logs = {}, {}
    for name, (target, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'parent {name}: nvcc exited {proc.returncode}\n{log}')
        logs[name] = [line.strip() for line in log.splitlines() if 'Used' in line or 'spill' in line]
        entry = f'morgana_{name}'
        _, ours = _kernels._ENTRIES[name, entry, None]
        lib = ctypes.CDLL(target)
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = ours.argtypes, ctypes.c_int
        lib.morgana_cuda_error_string.argtypes = [ctypes.c_int]
        lib.morgana_cuda_error_string.restype = ctypes.c_char_p
        entries[name, entry, None] = lib, fn
    return entries, logs


def attention_parent_phase(torch, dev, parent):
    """The parent tree's attention kernels beside this tree's in one process,
    in turns (parent, this, this, parent), through the same wrappers on the
    inputs of the timed k5 / k5_bwd cases: the forward at B16 (the serving
    batch) and B32, the backward at B32 (the training batch), T1024 H4 dh96,
    full, causal and causal with window 256. Both outputs are held to each
    other: the forward within KERNEL_TOL abs, the gradients within GRAD_RTOL
    of their largest |value|."""
    from morgana_tpu_torch.ops import flash_attention as fa

    # (B, causal, window, backward, seed): the inputs of main()'s timed k5 and
    # k5_bwd cases at dh 96.
    cases = [(SERVE_BATCH, False, None, False, 51)] + [
        (TRAIN_BATCH, causal, window, False, 52)
        for causal, window in ((False, None), (True, None), (True, 256))] + [
        (TRAIN_BATCH, False, None, True, 56), (TRAIN_BATCH, True, None, True, 57),
        (TRAIN_BATCH, True, 256, True, 58)]
    # Load this tree's libraries first: the parent's entries take their types.
    q, k, v, seq_len = attention_inputs(torch, dev, 1, 1, 1, 96, 0)
    o, lse = fa.attention_forward(q, k, v)
    fa.attention_backward(q, k, v, o, lse, o)
    entries, ptxas = build_parent_attention(parent)
    rows = []
    for batch, causal, window, backward, seed in cases:
        q, k, v, seq_len = attention_inputs(torch, dev, batch, 4, 1024, 96, seed)
        mask = dict(seq_len=seq_len, causal=causal, window=window)
        pairs = attention_pairs(seq_len.tolist(), 1024, 4, causal, window)
        if backward:
            o, lse = fa.attention_forward(q, k, v, **mask)
            rng = np.random.default_rng(seed + 100)
            weight = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(dev)
            weight = weight * valid_rows(torch, seq_len, 1024)
            fn, reps = (lambda: fa.attention_backward(q, k, v, o, lse, weight, **mask)), 10
        else:
            fn, reps = (lambda: fa.attention_forward(q, k, v, **mask)[0]), 20
        times, outs = {'parent': [], 'this': []}, {}
        for who in ('parent', 'this', 'this', 'parent'):
            with attention_kernels_of(entries) if who == 'parent' else contextlib.nullcontext():
                times[who].append(cuda_ms(torch, fn, reps))
                outs[who] = fn()
        torch.cuda.synchronize()
        if backward:
            scale = max(max(max_abs(g) for g in outs['parent']), 1e-30)
            err = max(max_abs(a - b) for a, b in zip(outs['this'], outs['parent'])) / scale
            tol = GRAD_RTOL
        else:
            err = max_abs((outs['this'] - outs['parent']) * valid_rows(torch, seq_len, 1024))
            tol = KERNEL_TOL
        bound, bound_by, simt = attention_bound(batch, 4, 1024, 96, pairs, backward)
        rows.append({'kernel': 'attn_bwd' if backward else 'attn_fwd', 'B': batch,
                     'causal': causal, 'window': window, 'visible_pairs': pairs,
                     'parent_ms': times['parent'], 'ms': times['this'],
                     'speedup': min(times['parent']) / max(times['this']),
                     'bound_ms': bound, 'bound_by': bound_by, 'simt_bound_ms': simt,
                     'err_vs_parent': err, 'tolerance': tol})
        if not err <= tol:
            raise AssertionError(f'this tree and the parent disagree: {rows[-1]}')
    emit({'phase': 'attn_parent_compare', 'parent': parent, 'parent_ptxas': ptxas,
          'order': 'parent, this, this, parent', 'rows': rows})
    return rows


def write_normalisers(root, rng):
    """Seeded statistics in the {name}_mvn.json / {name}_minmax.json layout."""
    norm_dir = os.path.join(root, 'train')
    os.makedirs(norm_dir)
    for name, dim in (('dur', 1), ('lf0', 1), ('mcep', 60), ('bap', 5),
                      ('lf0_deltas', 3), ('mcep_deltas', 180), ('bap_deltas', 15)):
        params = {'mean': rng.normal(size=dim).tolist(),
                  'std_dev': rng.uniform(0.2, 2.0, dim).tolist()}
        with open(os.path.join(norm_dir, f'{name}_mvn.json'), 'w') as f:
            json.dump(params, f)
    for name, dim in (('lab', 600), ('counters', 9)):
        low = rng.uniform(-1.0, 0.0, dim)
        with open(os.path.join(norm_dir, f'{name}_minmax.json'), 'w') as f:
            json.dump({'mmin': low.tolist(), 'mmax': (low + rng.uniform(0.5, 2.0, dim)).tolist()}, f)


def make_items(rng):
    """N_UTTS raw utterances of 200-1000 frames, the longest first."""
    lengths = rng.integers(200, 1001, N_UTTS)
    lengths[0], lengths[1] = 1000, 200
    items = []
    for i, n in enumerate(lengths):
        n = int(n)
        n_phones = n // 8
        dur = np.full((n_phones, 1), 8, np.float32)
        dur[-1] += n - 8 * n_phones
        items.append({
            'name': f'utt_{i:03d}',
            'n_frames': np.array([[n]], np.float32),
            'dur': dur,
            'lab': rng.random((n_phones, 600)).astype(np.float32),
            'counters': rng.random((n, 9)).astype(np.float32),
            'lf0': (5.0 + 0.2 * rng.normal(size=(n, 1))).astype(np.float32),
            'vuv': (rng.random((n, 1)) > 0.2).astype(np.float32),
            'mcep': (0.1 * rng.normal(size=(n, 60))).astype(np.float32),
            'bap': (-2.0 + 0.3 * rng.normal(size=(n, 5))).astype(np.float32),
        })
    return items


@contextlib.contextmanager
def lstm_store(store):
    """The LSTM layers of the 'pallas' backend store their recurrence in
    `store` ('bfloat16' or None) inside the block: ops.lstm.STORE_DTYPE, as
    MORGANA_PALLAS_STORE sets it at import."""
    from morgana_tpu_torch.ops import lstm as lstm_ops

    saved, lstm_ops.STORE_DTYPE = lstm_ops.STORE_DTYPE, store
    try:
        yield
    finally:
        lstm_ops.STORE_DTYPE = saved


def serving_phase(torch, root, phase='serve', store=None):
    """LSTMAcousticModel served at full width; with `store` 'bfloat16' the
    model's rnn_backend is 'pallas' with that storage (every K1 launch the
    bf16 variant), and its outputs are held to the CPU engine with the same
    storage within BF16_NET_TOL and closer to them in mean than the same GPU
    engine with f32 storage. Returns K1's launches (all, bf16) and what was
    served: {'root', 'ckpt', 'items', 'outputs'}."""
    with lstm_store(store):
        return _serving_phase(torch, os.path.join(root, phase) if store else root, phase, store)


def _serving_phase(torch, root, phase, store):
    from morgana_tpu_torch import data
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.serve import InferenceEngine
    from morgana_tpu_torch.viz.synthesis import MLPG_streams

    seed = 0
    rng = np.random.default_rng(seed)
    kwargs = {'rnn_backend': 'pallas'} if store else {}
    model = LSTMAcousticModel(generator=torch.Generator().manual_seed(seed))
    os.makedirs(root, exist_ok=True)
    ckpt = os.path.join(root, 'epoch_1.npz')
    np.savez(ckpt, **{k: v.detach().numpy() for k, v in model.named_parameters()})
    write_normalisers(root, rng)
    items = make_items(rng)

    engine = InferenceEngine(LSTMAcousticModel, ckpt, data_root=root, batch_size=SERVE_BATCH,
                             model_kwargs=kwargs)
    engine.predict_items(items[:2])   # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    lstm_ops.launches = lstm_ops.bf16_launches = 0
    start = time.perf_counter()
    outputs = engine.predict_items(items)      # returns host arrays: ends synchronised
    seconds = time.perf_counter() - start
    launches = lstm_ops.launches
    bf16_launches = lstm_ops.bf16_launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    n_batches = -(-N_UTTS // SERVE_BATCH)

    dims = ACOUSTIC_DIMS
    frames = 0
    for item in items:
        n = int(item['n_frames'].reshape(-1)[0])
        frames += n
        out = outputs[item['name']]
        for key, dim in dims.items():
            if out[key].shape != (n, dim) or not np.isfinite(out[key]).all():
                raise AssertionError(f"{item['name']} {key}: shape {out[key].shape}, "
                                     f'expected ({n}, {dim}), finite={np.isfinite(out[key]).all()}')
    if launches != 8 * n_batches or bf16_launches != (launches if store else 0):
        raise AssertionError(f'K1 launched {launches} times ({bf16_launches} bf16) for '
                             f'{n_batches} batches, expected {8 * n_batches}')

    # The same checkpoint on the CPU (plain versions) for the shortest utterances.
    few = sorted(items, key=lambda it: int(it['n_frames'].reshape(-1)[0]))[:4]
    cpu = InferenceEngine(LSTMAcousticModel, ckpt, data_root=root, device='cpu',
                          batch_size=SERVE_BATCH, model_kwargs=kwargs).predict_items(few)
    net_tol, traj_rtol = (BF16_NET_TOL, BF16_NET_TOL) if store else (NET_TOL, TRAJ_RTOL)
    errs = {}
    for key in dims:
        net = key.startswith('normalised') or key == 'vuv'
        worst = 0.0
        for it in few:
            a, b = outputs[it['name']][key], cpu[it['name']][key]
            err = float(np.abs(a - b).max())
            worst = max(worst, err if net else err / max(1.0, float(np.abs(b).max())))
        errs[key] = worst
        if worst > (net_tol if net else traj_rtol):
            raise AssertionError(f'{phase} {key}: GPU vs CPU {worst} beyond tolerance')
    control = {}
    if store:   # the control: the same GPU engine with f32 storage
        with lstm_store(None):
            f32 = engine.predict_items(few)

        def mean_err(got):
            return float(np.mean(np.concatenate([np.abs(got[it['name']][key] - cpu[it['name']][key])
                                                 .ravel() for it in few for key in dims])))
        control = {'max_abs': {key: max(float(np.abs(f32[it['name']][key]
                                                     - cpu[it['name']][key]).max()) for it in few)
                               for key in dims},
                   'mean_err_bf16': mean_err(outputs), 'mean_err_f32_storage': mean_err(f32)}
        if not control['mean_err_bf16'] < control['mean_err_f32_storage']:
            raise AssertionError(f'{phase}: the GPU engine with bf16 storage is not closer '
                                 f'to the CPU one than with f32 storage: {control}')

    # Where one full-size batch's time goes: host clock around synchronised
    # calls, and the profiler's device time by kernel.
    features = data.collate([data.assemble_item(
        engine.model.test_data_sources(), engine.model.normalisers,
        lambda name, source, item=item: source.package(item[name]), item['name'])
        for item in items[:SERVE_BATCH]])
    batch = data.device_features(features, engine.device)
    m = engine.model

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        timed(lambda: m.predict(batch))
        predict_ms = [timed(lambda: m.predict(batch))[1] for _ in range(3)]
        inputs, inputs_ms = timed(lambda: m.stream_inputs(batch))
        net, net_ms = timed(lambda: m.layers(inputs, seq_len=batch['n_frames']))
        heads = m._split_heads(net)
        streams = {}
        for name, pred in (('lf0', heads[0]), ('mcep', heads[2]), ('bap', heads[3])):
            std_dev = m.normalisers[name].fetch_params(deltas=True, like=pred)['std_dev']
            streams[name] = (m.normalisers[name].denormalise(pred, deltas=True), std_dev ** 2)
        _, mlpg_ms = timed(lambda: MLPG_streams(streams, padding_size=100,
                                                seq_len=batch['n_frames']))
        profile = profile_step(torch, lambda: m.predict(batch))
    emit({'phase': phase, 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
          'rnn_backend': kwargs.get('rnn_backend', 'scan'), 'store': store or 'float32',
          'utterances': N_UTTS, 'frames': frames, 'batch_size': SERVE_BATCH,
          'batches': n_batches, 'seconds': seconds,
          'utterances_per_s': N_UTTS / seconds, 'frames_per_s': frames / seconds,
          'ms_per_batch': seconds / n_batches * 1e3,
          'peak_memory_mib': peak_mib,
          'k1_launches': launches, 'k1_bf16_launches': bf16_launches,
          'k1_launches_expected': 8 * n_batches,
          'gpu_vs_cpu_err': errs, 'net_tol': net_tol, 'traj_rtol': traj_rtol,
          **({'f32_storage_err': control} if store else {})})
    emit(dict({'phase': 'batch_breakdown' + ('_bf16' if store else ''), 'B': SERVE_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'predict_ms': predict_ms, 'inputs_ms': inputs_ms, 'network_ms': net_ms,
               'mlpg_ms': mlpg_ms}, **profile))
    return launches, bf16_launches, {'root': root, 'ckpt': ckpt, 'items': items,
                                     'outputs': outputs}


def seeded_checkpoint(torch, model_class, path, seed):
    """A full-width model with weights from `seed`, saved as the JAX
    package's epoch_0.npz."""
    from morgana_tpu_torch import checkpointing, nn

    model = model_class(generator=torch.Generator().manual_seed(seed))
    return checkpointing.save_state_dict(nn.state_dict(model), path)


def train_corpus(root):
    """The training phases' synthetic corpus, written once under `root`: 64
    train + 16 valid utterances of 40-119 phones of 5-9 frames (about
    200-1070 frames). Returns its directory and the seconds it took (0 when
    it was there)."""
    from morgana_tpu_torch.data.synthetic import generate_voice_data

    data_root = os.path.join(root, 'train_data')
    if os.path.isdir(data_root):
        return data_root, 0.0
    start = time.perf_counter()
    generate_voice_data(data_root, num_train=64, num_valid=16, num_test=0, seed=7,
                        n_phones_range=(40, 120), dur_range=(5, 10))
    return data_root, time.perf_counter() - start


def builder_argv(data_root, experiments_base, name, ckpt, *flags):
    """The training command line of the main path: the JAX package's
    defaults, with the corpus, the init and the output named."""
    return ['--experiment_name', name, '--experiments_base', experiments_base,
            '--data_root', data_root, '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp', '--checkpoint_path', ckpt,
            *flags]


def train_phase(torch, root, phase='train', store=None):
    """Trains the full-width model for 2 epochs through the ExperimentBuilder
    on the card and checks what it wrote; then times and profiles steps.
    With `store` 'bfloat16', rnn_backend 'pallas' with that storage: every
    K1 and K2 launch is the bf16 variant. Returns the launches."""
    with lstm_store(store):
        return _train_phase(torch, root, phase, store)


def _train_phase(torch, root, phase, store):
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.ops import lstm as lstm_ops

    data_root, corpus_s = train_corpus(root)
    ckpt = seeded_checkpoint(torch, LSTMAcousticModel,
                             os.path.join(root, f'{phase}_init', 'epoch_0.npz'), 11)
    exp_base = os.path.join(root, 'experiments')
    flags = ['--model_kwargs', "{'rnn_backend': 'pallas'}"] if store else []
    args = ExperimentBuilder.get_experiment_args(
        builder_argv(data_root, exp_base, phase, ckpt, '--end_epoch', '2', *flags))
    exp = ExperimentBuilder(LSTMAcousticModel, **args)
    steps_per_epoch = len(exp.train_loader)
    valid_batches = len(exp.valid_loader)
    layers = sum(isinstance(m, nn.Recurrent) for m in exp.model.modules())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = {'k1': 'launches', 'k1_gates': 'gate_launches', 'k2': 'bwd_launches',
              'k1_bf16': 'bf16_launches', 'k2_bf16': 'bf16_bwd_launches'}
    for name in counts.values():
        setattr(lstm_ops, name, 0)
    start = time.perf_counter()
    exp.run_experiment()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    launches = {key: getattr(lstm_ops, name) for key, name in counts.items()}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    train_steps = 2 * steps_per_epoch
    expected = {'k1': layers * (train_steps + 2 * valid_batches),
                'k1_gates': layers * train_steps, 'k2': layers * train_steps}
    expected.update(k1_bf16=expected['k1'] if store else 0, k2_bf16=expected['k2'] if store else 0)
    if launches != expected:
        raise AssertionError(f'{phase}: launches {launches}, expected {expected}')
    exp_dir = os.path.join(exp_base, phase)
    epoch_metrics = {}
    for mode in ('train', 'valid'):
        for epoch in (1, 2):
            with open(os.path.join(exp_dir, mode, f'epoch_{epoch}', 'metrics.json')) as f:
                epoch_metrics[f'{mode}_{epoch}'] = json.load(f)
    step_losses = [x for epoch in (1, 2) for x in exp.train_losses[epoch]]
    values = step_losses + [v for m in epoch_metrics.values() for v in m.values()]
    if len(step_losses) != train_steps or not all(math.isfinite(v) for v in values):
        raise AssertionError(f'non-finite or missing losses/metrics: {step_losses} {epoch_metrics}')
    reloaded = LSTMAcousticModel()
    nn.load_jax_params(reloaded, np.load(os.path.join(exp_dir, 'checkpoints', 'epoch_2.npz')))
    for name in ('config.json', 'checkpoints/epoch_1.npz', 'model_summary.txt'):
        if not os.path.exists(os.path.join(exp_dir, name)):
            raise AssertionError(f'{name} was not written')

    # Steady-state steps on one full batch, then the MLPG's share of one.
    features, step_ms, profile = time_train_steps(torch, exp)

    emit({'phase': phase, 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
          'rnn_backend': 'pallas' if store else 'scan', 'store': store or 'float32',
          'corpus': '64 train + 16 valid, n_phones 40-119, dur 5-9', 'corpus_seconds': corpus_s,
          'batch_size': TRAIN_BATCH, 'epochs': 2, 'steps_per_epoch': steps_per_epoch,
          'run_seconds': run_s, 'step_losses': step_losses,
          'train_metrics': {k: v for k, v in epoch_metrics.items() if k.startswith('train')},
          'valid_metrics': {k: v for k, v in epoch_metrics.items() if k.startswith('valid')},
          'lstm_layers': layers, 'launches': launches, 'launches_expected': expected,
          'k1_gate_launches_per_step': launches['k1_gates'] / train_steps,
          'k2_launches_per_step': launches['k2'] / train_steps,
          'peak_memory_mib': peak_mib})
    emit(dict({'phase': phase + '_step_breakdown', 'B': TRAIN_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'frames': float(np.sum(features['n_frames'])),
               'step_ms': step_ms, 'median_step_ms_after_first': float(np.median(step_ms[1:])),
               'mlpg_host_ms': time_mlpg(torch, exp.model, features, exp.device)}, **profile))
    return launches


def time_mlpg(torch, model, features, device):
    """Host milliseconds of the fused three-stream MLPG of an acoustic
    model's predict on one collated batch, synchronised around it."""
    from morgana_tpu_torch.data import device_features
    from morgana_tpu_torch.viz.synthesis import MLPG_streams

    batch = device_features(features, device)
    with torch.no_grad():
        heads = model._split_heads(model.layers(model.stream_inputs(batch),
                                                seq_len=batch['n_frames']))
        streams = {}
        for name, pred in (('lf0', heads[0]), ('mcep', heads[2]), ('bap', heads[3])):
            std_dev = model.normalisers[name].fetch_params(deltas=True, like=pred)['std_dev']
            streams[name] = (model.normalisers[name].denormalise(pred, deltas=True), std_dev ** 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MLPG_streams(streams, padding_size=100, seq_len=batch['n_frames'])
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def time_train_steps(torch, exp):
    """Five train steps on one full batch of `exp`'s loader, host clock
    around synchronised calls, then one profiled step. Returns the batch,
    the step times in ms and the profile."""
    features = next(iter(exp.train_loader))
    exp.model.mode = 'train'
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.loop.train_step(features, exp.learning_rate)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    profile = profile_step(torch, lambda: exp.loop.train_step(features, exp.learning_rate))
    return features, step_ms, profile


def train_parity_phase(torch, root, model_class, phase='train_parity', seed=12, *flags):
    """The same trainer on the GPU and on the CPU, from one init and one
    corpus: per-step losses and the first step's gradients. `flags` go to
    both builders."""
    from morgana_tpu_torch.data.synthetic import generate_voice_data
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder

    data_root = os.path.join(root, 'parity_data')
    if not os.path.isdir(data_root):
        generate_voice_data(data_root, num_train=4, num_valid=0, num_test=0, seed=8,
                            n_phones_range=(20, 40), dur_range=(5, 8))
    ckpt = seeded_checkpoint(torch, model_class, os.path.join(root, f'{phase}_init', 'epoch_0.npz'),
                             seed)
    runs = {}
    for device in ('cuda', 'cpu'):
        args = ExperimentBuilder.get_experiment_args(builder_argv(
            data_root, os.path.join(root, f'{phase}_experiments'), device, ckpt,
            '--device', device, '--batch_size', '4', '--no-valid', '--end_epoch', '3', *flags))
        exp = ExperimentBuilder(model_class, **args)
        exp.model.mode = 'train'
        losses, grads, frames = [], None, []
        for _ in range(3):
            features = next(iter(exp.train_loader))
            frames.append(int(features['normalised_counters'].shape[1]))
            loss, _ = exp.loop.train_step(features, exp.learning_rate)
            losses.append(float(loss))
            if grads is None:
                grads = {n: p.grad.detach().cpu() for n, p in exp.model.named_parameters()}
        runs[device] = (losses, grads, frames)
    (gpu_losses, gpu_grads, frames), (cpu_losses, cpu_grads, _) = runs['cuda'], runs['cpu']
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses)]
    grad_rel = {n: float((gpu_grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                for n, g in cpu_grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    emit({'phase': phase, 'model': model_class.__name__, 'B': 4, 'padded_T': frames,
          'gpu_losses': gpu_losses, 'cpu_losses': cpu_losses, 'loss_rel_err': loss_rel,
          'loss_rtol': TRAIN_LOSS_RTOL, 'max_grad_rel_err': grad_rel[worst],
          'worst_param': worst, 'grad_rtol': TRAIN_GRAD_RTOL})
    if max(loss_rel) > TRAIN_LOSS_RTOL or grad_rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f'{phase}: GPU trainer disagrees with the CPU trainer')


KERNEL_KINDS = (('lstm_fwd_kernel', 'k1'), ('lstm_bwd_kernel', 'k2'), ('gru_fwd_kernel', 'k3'),
                ('gru_bwd_kernel', 'k4'), ('attn_fwd_kernel', 'attn_fwd'), ('attn_bwd', 'attn_bwd'))


def kernel_kind(name):
    """The part of a step a device kernel belongs to, by its name."""
    for key, kind in KERNEL_KINDS:
        if key in name:
            return kind
    lower = name.lower()
    if 'gemm' in lower:
        return 'gemm'
    if 'multi_tensor_apply' in lower or 'adam' in lower:
        return 'adam'
    return 'other'


def profile_step(torch, fn):
    """One profiled call: device time by kernel (K1-K4, the attention forward
    and backward, GEMMs, Adam's multi-tensor kernels, the rest), the number of kernels, and the host ops
    that took the most time. The table by device time goes to stderr."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = dict.fromkeys([kind for _, kind in KERNEL_KINDS] + ['gemm', 'adam', 'other'], 0.0)
    for e in kernels:
        device_us[kernel_kind(e.key)] += e.self_device_time_total
    busy_ms = sum(device_us.values()) / 1e3
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    print(events.table(sort_by='self_device_time_total', row_limit=15), file=sys.stderr)
    return {'profiled_wall_ms': wall_ms,
            'device_busy_ms': busy_ms if kernels else 'not measured',
            'device_idle_share': 1 - busy_ms / wall_ms if kernels else 'not measured',
            **{f'{kind}_device_ms': us / 1e3 for kind, us in device_us.items()},
            'kernels_launched': sum(e.count for e in kernels),
            'top_host_ops': [[e.key, e.self_cpu_time_total / 1e3, e.count] for e in host]}


def f0_items(rng):
    """make_items' utterances with what F0Model's test sources also read:
    n_phones, and the WORLD spectra sp and ap (513 bins) of its valid
    analysis."""
    items = make_items(rng)
    for item in items:
        n = int(item['n_frames'].reshape(-1)[0])
        item['n_phones'] = np.array([[item['dur'].shape[0]]], np.float32)
        item['sp'] = rng.random((n, 513), dtype=np.float32)
        item['ap'] = rng.random((n, 513), dtype=np.float32)
    return items


def engine_serving_phase(torch, root, model_class, phase, label, make, dims, ops, name, layers,
                         seed):
    """`model_class` at full width, seeded weights and normaliser statistics,
    served by InferenceEngine.predict_items: the utterances of `make` at
    B=16; shapes and finiteness of the outputs in `dims`, `layers` forward
    launches per batch of the kernel counted by `ops` (reported as `name`)
    and none of its backward, agreement with the CPU engine, throughput,
    peak memory and where a batch's time goes."""
    from morgana_tpu_torch import data
    from morgana_tpu_torch.serve import InferenceEngine

    serve_root = os.path.join(root, phase)
    os.makedirs(serve_root)
    rng = np.random.default_rng(seed)
    ckpt = seeded_checkpoint(torch, model_class, os.path.join(serve_root, 'epoch_1.npz'), seed)
    write_normalisers(serve_root, rng)
    items = make(rng)

    engine = InferenceEngine(model_class, ckpt, data_root=serve_root, batch_size=SERVE_BATCH)
    engine.predict_items(items[:2])   # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.launches = ops.bwd_launches = 0
    start = time.perf_counter()
    outputs = engine.predict_items(items)      # returns host arrays: ends synchronised
    seconds = time.perf_counter() - start
    launches = ops.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    n_batches = -(-N_UTTS // SERVE_BATCH)

    frames = 0
    for item in items:
        n = int(item['n_frames'].reshape(-1)[0])
        frames += n
        out = outputs[item['name']]
        for key, dim in dims.items():
            if out[key].shape != (n, dim) or not np.isfinite(out[key]).all():
                raise AssertionError(f"{item['name']} {key}: shape {out[key].shape}, "
                                     f'expected ({n}, {dim}), finite={np.isfinite(out[key]).all()}')
    expected = layers * n_batches
    if launches != expected or ops.bwd_launches:
        raise AssertionError(f'{name} launched {launches} times (backward {ops.bwd_launches}) '
                             f'for {n_batches} batches, expected {expected} (backward 0)')

    # The same checkpoint on the CPU (plain versions) for the shortest utterances.
    few = sorted(items, key=lambda it: int(it['n_frames'].reshape(-1)[0]))[:4]
    cpu = InferenceEngine(model_class, ckpt, data_root=serve_root, device='cpu',
                          batch_size=SERVE_BATCH).predict_items(few)
    errs = {}
    for key in dims:
        net = key.startswith('normalised') or key == 'vuv'
        worst = 0.0
        for it in few:
            a, b = outputs[it['name']][key], cpu[it['name']][key]
            err = float(np.abs(a - b).max())
            worst = max(worst, err if net else err / max(1.0, float(np.abs(b).max())))
        errs[key] = worst
        if worst > (NET_TOL if net else TRAJ_RTOL):
            raise AssertionError(f'{model_class.__name__} {key}: GPU vs CPU {worst} beyond tolerance')

    features = data.collate([data.assemble_item(
        engine.model.test_data_sources(), engine.model.normalisers,
        lambda name, source, item=item: source.package(item[name]), item['name'])
        for item in items[:SERVE_BATCH]])
    batch = data.device_features(features, engine.device)
    with torch.inference_mode():
        profile = profile_step(torch, lambda: engine.model.predict(batch))
    emit(dict({'phase': phase, 'model': label,
               'utterances': N_UTTS, 'frames': frames, 'batch_size': SERVE_BATCH,
               'batches': n_batches, 'seconds': seconds, 'utterances_per_s': N_UTTS / seconds,
               'frames_per_s': frames / seconds, 'ms_per_batch': seconds / n_batches * 1e3,
               'peak_memory_mib': peak_mib, f'{name}_launches': launches,
               f'{name}_launches_expected': expected, 'gpu_vs_cpu_err': errs, 'net_tol': NET_TOL,
               'traj_rtol': TRAJ_RTOL,
               'profiled_batch_T': int(features['normalised_counters'].shape[1])},
              **profile))
    return launches


def f0_serving_phase(torch, root):
    """F0Model (609 inputs, 3 x GRU(64), 3 outputs) through
    engine_serving_phase: 3 launches of K3 per batch."""
    from morgana_tpu_torch.models.f0_test_model import F0Model
    from morgana_tpu_torch.ops import gru as gru_ops

    return engine_serving_phase(torch, root, F0Model, 'f0_serving', 'F0Model 609-3xGRU(64)-3',
                                f0_items, {'normalised_lf0_deltas': 3, 'lf0': 1}, gru_ops, 'k3',
                                F0_LAYERS, 20)


def transformer_serving_phase(torch, root):
    """TransformerAcousticModel at its defaults (609 -> 384, 6 blocks of 4
    heads of 96, d_ff 1536, 199 outputs) through engine_serving_phase: 6
    launches of the attention forward per batch."""
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
    from morgana_tpu_torch.ops import flash_attention as fa

    return engine_serving_phase(torch, root, TransformerAcousticModel, 'transformer_serving',
                                'TransformerAcousticModel 609-6x(384, 4 heads, 1536)-199',
                                make_items, ACOUSTIC_DIMS, fa, 'attn_fwd', TRANSFORMER_BLOCKS, 40)


def transformer_train_phase(torch, root):
    """TransformerAcousticModel through builder_train_phase at lr 0.001 (the
    rate its JAX docstring recommends), then steady-state steps on one full
    batch, one profiled step and the MLPG's share of it."""
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
    from morgana_tpu_torch.ops import flash_attention as fa

    launches, exp, exp_dir = builder_train_phase(
        torch, root, TransformerAcousticModel, 'transformer_train', fa, ('attn_fwd', 'attn_bwd'),
        nn.MultiHeadAttention, TRANSFORMER_BLOCKS, 41, '--learning_rate', TRANSFORMER_LR)
    with open(os.path.join(exp_dir, 'train', 'epoch_2', 'metrics.json')) as f:
        frames_per_s = json.load(f)['frames_per_sec']
    features, step_ms, profile = time_train_steps(torch, exp)
    emit(dict({'phase': 'transformer_train_step_breakdown', 'B': TRAIN_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'frames': float(np.sum(features['n_frames'])), 'step_ms': step_ms,
               'median_step_ms_after_first': float(np.median(step_ms[1:])),
               'epoch_2_frames_per_s': frames_per_s,
               'mlpg_host_ms': time_mlpg(torch, exp.model, features, exp.device)}, **profile))
    return launches


def transformer_dropout_phase(torch, root):
    """TransformerAcousticModel(dropout_prob=0.1) trained for 1 epoch with
    validation through the ExperimentBuilder at lr 0.001 (B=32): as in the
    JAX package (nn.py:913-941), probability dropout in training leaves the
    attention kernels for the exact plain path, so a train step launches
    none, forward or backward; validation (eval mode, no dropout) launches
    the forward kernel 6 times a batch. Finite losses and metrics."""
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
    from morgana_tpu_torch.ops import flash_attention as fa

    data_root, _ = train_corpus(root)
    ckpt = seeded_checkpoint(torch, TransformerAcousticModel,
                             os.path.join(root, 'transformer_dropout_init', 'epoch_0.npz'), 44)
    args = ExperimentBuilder.get_experiment_args(builder_argv(
        data_root, os.path.join(root, 'experiments'), 'transformer_dropout', ckpt,
        '--end_epoch', '1', '--learning_rate', TRANSFORMER_LR,
        '--model_kwargs', "{'dropout_prob': 0.1}"))
    exp = ExperimentBuilder(TransformerAcousticModel, **args)
    steps, valid_batches = len(exp.train_loader), len(exp.valid_loader)
    torch.cuda.synchronize()
    fa.launches = fa.bwd_launches = 0
    start = time.perf_counter()
    exp.run_experiment()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    launches = {'attn_fwd': fa.launches, 'attn_bwd': fa.bwd_launches}
    expected = {'attn_fwd': TRANSFORMER_BLOCKS * valid_batches, 'attn_bwd': 0}
    with open(os.path.join(root, 'experiments', 'transformer_dropout', 'valid', 'epoch_1',
                           'metrics.json')) as f:
        valid_metrics = json.load(f)
    losses = list(exp.train_losses[1])
    values = losses + list(valid_metrics.values())
    emit({'phase': 'transformer_dropout', 'model': 'TransformerAcousticModel(dropout_prob=0.1)',
          'batch_size': TRAIN_BATCH, 'epochs': 1, 'steps': steps, 'valid_batches': valid_batches,
          'run_seconds': run_s, 'step_losses': losses, 'valid_metrics': valid_metrics,
          'launches': launches, 'launches_expected': expected,
          'attention_launches_per_train_step': (launches['attn_fwd'] - expected['attn_fwd']
                                                + launches['attn_bwd']) / steps})
    if launches != expected or len(losses) != steps or not all(math.isfinite(x) for x in values):
        raise AssertionError(f'transformer_dropout: launches {launches}, expected {expected}; '
                             f'losses {losses}')
    return launches


def builder_train_phase(torch, root, model_class, phase, ops, names, layer_class, layers, seed,
                        *flags):
    """Trains `model_class` for 2 epochs with validation through the
    ExperimentBuilder on the train corpus, from a seeded epoch_0.npz; checks
    the launches of the kernels counted by `ops` (its `launches` and
    `bwd_launches`, reported under `names`): `layers` (the number of
    `layer_class` modules) of each per train step and forward ones alone per
    valid batch; finite losses and metrics and the checkpoint's strict
    reload. Returns the launches, the experiment and its directory."""
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder

    data_root, corpus_s = train_corpus(root)
    ckpt = seeded_checkpoint(torch, model_class, os.path.join(root, f'{phase}_init', 'epoch_0.npz'),
                             seed)
    exp_base = os.path.join(root, 'experiments')
    args = ExperimentBuilder.get_experiment_args(
        builder_argv(data_root, exp_base, phase, ckpt, '--end_epoch', '2', *flags))
    exp = ExperimentBuilder(model_class, **args)
    steps_per_epoch = len(exp.train_loader)
    valid_batches = len(exp.valid_loader)
    if sum(isinstance(m, layer_class) for m in exp.model.modules()) != layers:
        raise AssertionError(f'{model_class.__name__} does not have {layers} '
                             f'{layer_class.__name__} layers')

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.launches = ops.bwd_launches = 0
    start = time.perf_counter()
    exp.run_experiment()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    fwd, bwd = names
    launches = {fwd: ops.launches, bwd: ops.bwd_launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    train_steps = 2 * steps_per_epoch
    expected = {fwd: layers * (train_steps + 2 * valid_batches), bwd: layers * train_steps}
    if launches != expected:
        raise AssertionError(f'{phase}: launches {launches}, expected {expected}')
    exp_dir = os.path.join(exp_base, phase)
    epoch_metrics = {}
    for mode in ('train', 'valid'):
        for epoch in (1, 2):
            with open(os.path.join(exp_dir, mode, f'epoch_{epoch}', 'metrics.json')) as f:
                epoch_metrics[f'{mode}_{epoch}'] = json.load(f)
    step_losses = [x for epoch in (1, 2) for x in exp.train_losses[epoch]]
    values = step_losses + [v for m in epoch_metrics.values() for v in m.values()]
    if len(step_losses) != train_steps or not all(math.isfinite(v) for v in values):
        raise AssertionError(f'{phase}: non-finite or missing losses/metrics: {step_losses} '
                             f'{epoch_metrics}')
    nn.load_jax_params(model_class(), np.load(os.path.join(exp_dir, 'checkpoints', 'epoch_2.npz')))
    emit({'phase': phase, 'model': model_class.__name__,
          'corpus': '64 train + 16 valid, n_phones 40-119, dur 5-9', 'corpus_seconds': corpus_s,
          'batch_size': TRAIN_BATCH, 'epochs': 2, 'steps_per_epoch': steps_per_epoch,
          'valid_batches': valid_batches, 'run_seconds': run_s, 'step_losses': step_losses,
          'train_metrics': {k: v for k, v in epoch_metrics.items() if k.startswith('train')},
          'valid_metrics': {k: v for k, v in epoch_metrics.items() if k.startswith('valid')},
          'layers': layers, 'launches': launches, 'launches_expected': expected,
          f'{fwd}_launches_per_train_step': (launches[fwd] - 2 * layers * valid_batches) / train_steps,
          f'{fwd}_launches_per_valid_batch': layers,
          f'{bwd}_launches_per_train_step': launches[bwd] / train_steps,
          'peak_memory_mib': peak_mib})
    return launches, exp, exp_dir


def gru_train_phase(torch, root, model_class, phase, layers, seed, *flags):
    """builder_train_phase for a GRU model: K3 and K4, one each per GRU
    layer."""
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.ops import gru as gru_ops

    return builder_train_phase(torch, root, model_class, phase, gru_ops, ('k3', 'k4'),
                               nn.Recurrent, layers, seed, *flags)


def f0_train_phase(torch, root, smi):
    """F0Model through gru_train_phase with the builder's defaults but
    --valid_output_interval 1 (its validation analysis synthesises a wav per
    valid utterance each epoch: f0_valid_synth_check), then steady-state
    steps on one full batch, one profiled step and the MLPG's share of it."""
    from morgana_tpu_torch.data import device_features
    from morgana_tpu_torch.models.f0_test_model import F0Model
    from morgana_tpu_torch.viz.synthesis import MLPG

    launches, exp, exp_dir = gru_train_phase(torch, root, F0Model, 'f0_train', F0_LAYERS, 21,
                                             '--valid_output_interval', '1')
    f0_valid_synth_check(exp_dir, smi)
    features, step_ms, profile = time_train_steps(torch, exp)
    model = exp.model
    batch = device_features(features, exp.device)
    with torch.no_grad():
        pred = model.layers(model.stream_inputs(batch), seq_len=batch['n_frames'])
        normaliser = model.normalisers['lf0']
        variance = normaliser.fetch_params(deltas=True, like=pred)['std_dev'] ** 2
        deltas = normaliser.denormalise(pred, deltas=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MLPG(deltas, variance, padding_size=100, seq_len=batch['n_frames'])
        torch.cuda.synchronize()
        mlpg_ms = (time.perf_counter() - t0) * 1e3
    emit(dict({'phase': 'f0_train_step_breakdown', 'B': TRAIN_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'frames': float(np.sum(features['n_frames'])),
               'step_ms': step_ms, 'median_step_ms_after_first': float(np.median(step_ms[1:])),
               'mlpg_host_ms': mlpg_ms}, **profile))
    return launches


def duration_train_phase(torch, root):
    """DurationModel (GRU(128)) through gru_train_phase with its validation
    analysis every epoch; checks the feats/dur/*.npy it writes."""
    from morgana_tpu_torch.data import file_io
    from morgana_tpu_torch.models.duration_model import DurationModel

    launches, exp, exp_dir = gru_train_phase(torch, root, DurationModel, 'duration_train', 1, 22,
                                             '--valid_output_interval', '1')
    data_root = os.path.join(root, 'train_data')
    ids = file_io.get_file_ids(os.path.join(data_root, 'valid', 'valid_file_id_list.scp'))
    for epoch in (1, 2):
        feats = os.path.join(exp_dir, 'valid', f'epoch_{epoch}', 'feats', 'dur')
        for utt in ids:
            dur = np.load(os.path.join(feats, f'{utt}.npy'))
            n_phones = int(np.loadtxt(os.path.join(data_root, 'valid', 'n_phones', f'{utt}.txt')))
            if dur.shape != (n_phones,) or not np.isfinite(dur).all():
                raise AssertionError(f'{feats}/{utt}.npy: shape {dur.shape}, expected '
                                     f'({n_phones},), finite={np.isfinite(dur).all()}')
    features, step_ms, profile = time_train_steps(torch, exp)
    emit(dict({'phase': 'duration_train_step_breakdown', 'B': TRAIN_BATCH,
               'T': int(features['normalised_lab'].shape[1]),
               'phones': float(np.sum(features['n_phones'])), 'step_ms': step_ms,
               'median_step_ms_after_first': float(np.median(step_ms[1:])),
               'valid_analysis_files_checked': 2 * len(ids)}, **profile))
    return launches


# ---------------------------------------------------------------- vocoder

def vowel_features(rng, num_frames, f0_hz):
    """Model-space features (f0 in Hz, vuv, 60 mcep, 5 bap) of a nearly
    periodic two-formant vowel with an 8 Hz vibrato."""
    from morgana_tpu_torch.vocoder import world

    t = np.arange(num_frames)
    f0 = f0_hz + 8.0 * np.sin(2 * np.pi * t / 40.0)
    bins = np.linspace(0, FS / 2, 513)
    env = (0.6 * np.exp(-0.5 * ((bins - 700) / 180.0) ** 2)
           + 0.4 * np.exp(-0.5 * ((bins - 1800) / 260.0) ** 2) + 1e-3)
    sp = np.tile(env ** 2, (num_frames, 1)) * (1 + 0.05 * rng.standard_normal((num_frames, 1)))
    mcep = world.spectrum_to_mcep(sp, order=59, fs=FS)
    bap = -8.0 + 0.3 * rng.standard_normal((num_frames, 5))
    return f0, np.ones(num_frames), mcep, bap


def wave_agreement(got, want):
    """Relative L2 error, and the energy and peak ratios minus 1, of two
    waveforms (float64)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return {'rel_l2': float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)),
            'energy': float(np.sqrt((got ** 2).mean() / max((want ** 2).mean(), 1e-60)) - 1),
            'peak': float(np.abs(got).max() / max(np.abs(want).max(), 1e-30) - 1)}


def hold_wave(label, got, want, exact, rtol):
    """`exact` (no pulse may differ: unvoiced, or the same pulse train):
    relative L2 within `rtol`; else energy and peak within
    VOICED_RATIO_TOL. Returns the agreement numbers."""
    agree = wave_agreement(got, want)
    ok = (agree['rel_l2'] <= rtol if exact
          else abs(agree['energy']) <= VOICED_RATIO_TOL and abs(agree['peak']) <= VOICED_RATIO_TOL)
    if not ok:
        raise AssertionError(f'{label}: {agree} beyond tolerance (exact={exact}, rtol={rtol})')
    return agree


def vocoder_native_phase(smi):
    """The port's world_synth.cpp built by g++ (morgana_tpu_torch/build/)
    and loaded; 5 s of a seeded vowel through it and through the NumPy path,
    both float64 with their own noise generators (XorShift, PCG64) on a
    nearly periodic signal: within NATIVE_RTOL. Host times are the card
    machine's CPU."""
    from morgana_tpu_torch import _build
    from morgana_tpu_torch.vocoder import world

    start = time.perf_counter()
    library = _build.build_cxx('world_synth', world.SOURCE)
    build_s = time.perf_counter() - start
    if not world.native_available():
        raise AssertionError('vocoder_native: the native library did not load')
    f0, _, mcep, bap = vowel_features(np.random.default_rng(70), 1000, 140.0)
    sp, ap = world.mcep_to_spectrum(mcep, fs=FS), world.bap_to_aperiodicity(bap, fs=FS)
    audio_s = len(f0) * HOP / FS
    times = {}
    waves = {}
    for path, fn in (('native', lambda: world.synthesize(f0, sp, ap, FS)),
                     ('numpy', lambda: world._synthesize_numpy(f0, sp, ap, FS, HOP))):
        fn()
        t0 = time.perf_counter()
        waves[path] = fn()
        times[path] = (time.perf_counter() - t0) * 1e3 / audio_s
    if not all(np.isfinite(w).all() and w.shape == (len(f0) * HOP,) for w in waves.values()):
        raise AssertionError('vocoder_native: a path gave a non-finite or misshapen wave')
    agree = wave_agreement(waves['native'], waves['numpy'])
    emit({'phase': 'vocoder_native', 'card': smi, 'library': os.path.relpath(library),
          'cxx_flags': list(_build.CXX_FLAGS), 'build_seconds': build_s, 'native_loaded': True,
          'frames': len(f0), 'audio_seconds': audio_s,
          'host_ms_per_audio_s': times, 'host': "the card machine's CPU, one thread",
          'native_vs_numpy': agree, 'rtol': NATIVE_RTOL})
    if agree['rel_l2'] > NATIVE_RTOL:
        raise AssertionError(f'vocoder_native: native vs NumPy {agree} beyond {NATIVE_RTOL}')


def vocoder_batch_phase(torch, dev, served, smi):
    """torch_world.synthesize_batch on the card at B16, T = VOCODER_T frames
    (the 16 longest served utterances, 80,000 samples a row): the LSTM
    serving phase's predicted features (unvoiced: the seeded model's vuv
    stays below 0.5), and seeded vowels of the same lengths (voiced). Each
    row's noise is the host path's draw (default_rng(100 + row)). Two card
    runs give the same bits; each row agrees with the same call on the CPU
    (relative L2 within VOCODER_RTOL where the two pulse trains are the same,
    else energy and peak within VOICED_RATIO_TOL) and with the float64 host
    path world._synthesize_numpy (relative L2 within HOST_VOCODER_RTOL
    unvoiced, energy and peak voiced). Card ms by CUDA events, real-time
    factor, peak memory; the host's native library on the same rows for
    comparison."""
    from morgana_tpu_torch.vocoder import torch_world, world

    outputs = served['outputs']
    names = sorted(outputs, key=lambda n: -outputs[n]['lf0'].shape[0])[:SERVE_BATCH]
    lens = [outputs[n]['lf0'].shape[0] for n in names]
    if max(lens) != VOCODER_T:
        raise AssertionError(f'vocoder_batch: longest served utterance {max(lens)} frames')
    rng = np.random.default_rng(71)
    sets = {'lstm': [(np.exp(outputs[n]['lf0'][:, 0]), outputs[n]['vuv'][:, 0],
                      outputs[n]['mcep'], outputs[n]['bap']) for n in names],
            'vowel': [vowel_features(rng, n, VOWEL_F0 + 10 * i) for i, n in enumerate(lens)]}
    noise = np.zeros((SERVE_BATCH, VOCODER_T * HOP), np.float32)
    for i, n in enumerate(lens):
        noise[i, :n * HOP] = np.random.default_rng(100 + i).standard_normal(n * HOP)
    seq_len = np.array(lens)
    audio_s = float(seq_len.sum()) * HOP / FS
    line = {'phase': 'vocoder_batch', 'card': smi, 'B': SERVE_BATCH, 'T': VOCODER_T,
            'samples_per_row': VOCODER_T * HOP, 'frames': int(seq_len.sum()),
            'audio_seconds': audio_s, 'rtol_vs_cpu': VOCODER_RTOL,
            'rtol_vs_host_float64': HOST_VOCODER_RTOL, 'voiced_ratio_tol': VOICED_RATIO_TOL}
    for label, rows in sets.items():
        f0, vuv = np.zeros((2, SERVE_BATCH, VOCODER_T), np.float32)
        mcep = np.zeros((SERVE_BATCH, VOCODER_T, 60), np.float32)
        bap = np.zeros((SERVE_BATCH, VOCODER_T, 5), np.float32)
        for i, (n, row) in enumerate(zip(lens, rows)):
            f0[i, :n], vuv[i, :n], mcep[i, :n], bap[i, :n] = row
        args = [torch.from_numpy(a).to(dev) for a in (f0, vuv, mcep, bap, seq_len)]
        noise_dev = torch.from_numpy(noise).to(dev)

        def card():
            return torch_world.synthesize_batch(*args, FS, noise=noise_dev)[0]

        first, second = card().cpu(), card().cpu()
        if not torch.equal(first, second):
            raise AssertionError(f'vocoder_batch {label}: two card runs differ')
        cpu = torch_world.synthesize_batch(f0, vuv, mcep, bap, seq_len, FS, noise=noise,
                                           device='cpu')[0]
        mask = np.arange(VOCODER_T)[None, :] < seq_len[:, None]
        voiced_f0 = np.where(vuv > 0.5, f0, 0.0) * mask
        trains = [(torch_world.pulse_train(torch.from_numpy(voiced_f0.astype(np.float32))
                                           .to(d), FS, HOP) != 0).cpu() for d in (dev, 'cpu')]
        vs_cpu, vs_host, same_pulses = [], [], 0
        for i, n in enumerate(lens):
            same = torch.equal(trains[0][i], trains[1][i])
            same_pulses += same
            vs_cpu.append(hold_wave(f'vocoder_batch {label} row {i} vs CPU', first[i], cpu[i],
                                    same, VOCODER_RTOL))
            host = world._synthesize_numpy(
                voiced_f0[i, :n].astype(np.float64),
                world.mcep_to_spectrum(mcep[i, :n], fs=FS),
                world.bap_to_aperiodicity(bap[i, :n], fs=FS), FS, HOP, seed=100 + i)
            vs_host.append(hold_wave(f'vocoder_batch {label} row {i} vs host', first[i, :n * HOP],
                                     host, not voiced_f0[i].any(), HOST_VOCODER_RTOL))
        ms = cuda_ms(torch, card, reps=5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        card()
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        t0 = time.perf_counter()
        for i, n in enumerate(lens):
            world.synthesize_world_feats(voiced_f0[i, :n], vuv[i, :n], mcep[i, :n], bap[i, :n],
                                         FS)
        host_s = time.perf_counter() - t0
        line[label] = {
            'voiced_frames': int((voiced_f0 > 0).sum()), 'card_ms': ms,
            'real_time_factor': audio_s / (ms / 1e3), 'peak_memory_mib': peak_mib,
            'card_runs_bit_identical': True, 'rows_with_the_cpu_pulse_train': same_pulses,
            'max_vs_cpu': {k: max(abs(a[k]) for a in vs_cpu) for k in vs_cpu[0]},
            'max_vs_host_float64': {k: max(abs(a[k]) for a in vs_host) for k in vs_host[0]},
            'host_native_seconds': host_s, 'host_native_real_time_factor': audio_s / host_s,
            'host': "the card machine's CPU, one thread, world.synthesize_world_feats"}
    emit(line)


def write_items(root, split, items, sources):
    """The served utterances as a corpus split under `root` (the sources'
    file layout) with its id list. Returns the id list's path under
    `root`."""
    from morgana_tpu_torch.data import data_sources, file_io

    for item in items:
        for name, source in sources.items():
            path = source.file_path(item['name'], os.path.join(root, split))
            if isinstance(source, data_sources.TextSource):
                file_io.save_txt(item[name], path)
            else:
                file_io.save_bin(item[name], path)
    id_list = os.path.join(split, f'{split}_file_id_list.scp')
    file_io.save_lines([item['name'] for item in items], os.path.join(root, id_list))
    return id_list


@contextlib.contextmanager
def timed_wav_writes():
    """Sums the seconds spent in file_io.save_wav, which the analysis hooks
    call, into the yielded dict's 'seconds'."""
    from morgana_tpu_torch.data import file_io

    spent = {'seconds': 0.0, 'files': 0}
    save_wav = file_io.save_wav

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        save_wav(*args, **kwargs)
        spent['seconds'] += time.perf_counter() - t0
        spent['files'] += 1

    file_io.save_wav = timed
    try:
        yield spent
    finally:
        file_io.save_wav = save_wav


def check_wavs(label, synth_dir, lengths):
    """One wav per name of `lengths` in `synth_dir`, each lengths[name] * HOP
    samples. Returns the wavs."""
    from morgana_tpu_torch.data import file_io

    if sorted(os.listdir(synth_dir)) != sorted(f'{name}.wav' for name in lengths):
        raise AssertionError(f'{label}: {synth_dir} holds {sorted(os.listdir(synth_dir))}')
    wavs = {}
    for name, n in lengths.items():
        wav, rate = file_io.load_wav(os.path.join(synth_dir, f'{name}.wav'))
        if wav.shape != (n * HOP,) or rate != FS:
            raise AssertionError(f'{label} {name}: {wav.shape} at {rate} Hz, expected '
                                 f'({n * HOP},) at {FS}')
        wavs[name] = wav
    return wavs


def generate_lstm_phase(torch, served, smi):
    """InferenceEngine(LSTMAcousticModel, device=None).generate at full width
    over the serving phase's 32 utterances (written as a corpus split) at
    B16: 32 wavs of n_frames * 80 samples, 8 K1 launches a batch, the
    shortest utterance's wav against the CPU engine's (energy and peak
    within VOICED_RATIO_TOL); throughput and where the seconds went. Then
    the serving command line once on the same checkpoint. Returns K1's
    launches."""
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.serve import InferenceEngine

    root, ckpt, items = served['root'], served['ckpt'], served['items']
    engine = InferenceEngine(LSTMAcousticModel, ckpt, data_root=root, batch_size=SERVE_BATCH)
    id_list = write_items(root, 'generate', items, engine.model.test_data_sources())
    lengths = {item['name']: int(item['n_frames'].reshape(-1)[0]) for item in items}
    out_dir = os.path.join(root, 'generated')
    torch.cuda.synchronize()
    lstm_ops.launches = 0
    with timed_wav_writes() as writes:
        stats = engine.generate(out_dir, data_dir='generate', id_list=id_list)
    launches = lstm_ops.launches
    n_batches = -(-N_UTTS // SERVE_BATCH)
    if launches != 8 * n_batches or stats['utterances'] != N_UTTS:
        raise AssertionError(f'generate_lstm: K1 launched {launches} times for {n_batches} '
                             f'batches, {stats["utterances"]} utterances')
    wavs = check_wavs('generate_lstm', os.path.join(out_dir, 'synth'), lengths)

    shortest = min(lengths, key=lengths.get)
    cpu_dir = os.path.join(root, 'generated_cpu')
    InferenceEngine(LSTMAcousticModel, ckpt, data_root=root, batch_size=SERVE_BATCH,
                    device='cpu').generate(cpu_dir, data_dir='generate', file_ids=[shortest])
    cpu_wav = check_wavs('generate_lstm cpu', os.path.join(cpu_dir, 'synth'),
                         {shortest: lengths[shortest]})[shortest]
    vs_cpu = hold_wave('generate_lstm vs CPU engine', wavs[shortest], cpu_wav, False, 0.0)

    cli_dir = os.path.join(root, 'generated_cli')
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'morgana_tpu_torch.serve', '--model',
         'morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel', '--checkpoint_path', ckpt,
         '--data_root', root, '--data_dir', 'generate', '--out_dir', cli_dir,
         '--batch_size', str(SERVE_BATCH)],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f'generate_lstm: the serving CLI exited {proc.returncode}\n'
                             f'{proc.stderr[-4000:]}')
    cli_stats = json.loads(proc.stdout.strip().splitlines()[-1])
    check_wavs('generate_lstm cli', os.path.join(cli_dir, 'synth'), lengths)

    split = dict(stats['split_seconds'])
    split['vocoder'] = split['analysis'] - writes['seconds']
    split['writes'] = writes['seconds']
    seconds = stats['seconds']
    emit({'phase': 'generate_lstm', 'card': smi, 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
          'utterances': stats['utterances'], 'frames': stats['frames'], 'batch_size': SERVE_BATCH,
          'batches': n_batches, 'seconds': seconds, 'utterances_per_s': N_UTTS / seconds,
          'frames_per_s': stats['frames'] / seconds,
          'audio_seconds_per_s': stats['frames'] * HOP / FS / seconds,
          'split_seconds': split, 'wav_files': writes['files'],
          'host': "predict's MLPG, the vocoder and the writes run on the card machine's CPU",
          'k1_launches': launches, 'k1_launches_expected': 8 * n_batches,
          'cpu_engine_check': {'utterance': shortest, **vs_cpu,
                               'ratio_tol': VOICED_RATIO_TOL},
          'cli': {'seconds': cli_s, 'utterances': cli_stats['utterances'],
                  'seconds_inside': cli_stats['seconds']}})
    return launches


def f0_valid_synth_check(exp_dir, smi):
    """The f0_train phase's validation analysis (--valid_output_interval 1):
    valid/epoch_{1,2}/synth/ holds one wav per valid utterance, n_frames *
    80 samples."""
    from morgana_tpu_torch.data import file_io

    data_root = os.path.join(os.path.dirname(os.path.dirname(exp_dir)), 'train_data')
    ids = file_io.get_file_ids(os.path.join(data_root, 'valid', 'valid_file_id_list.scp'))
    lengths = {utt: int(np.loadtxt(os.path.join(data_root, 'valid', 'n_frames', f'{utt}.txt')))
               for utt in ids}
    for epoch in (1, 2):
        check_wavs('f0_valid_synth', os.path.join(exp_dir, 'valid', f'epoch_{epoch}', 'synth'),
                   lengths)
    emit({'phase': 'f0_valid_synth', 'card': smi, 'epochs': [1, 2], 'wavs_per_epoch': len(ids),
          'frames_per_epoch': sum(lengths.values()),
          'audio_seconds_per_epoch': sum(lengths.values()) * HOP / FS})


def builder_test_phase(torch, root, smi):
    """--test without training (--no-train --no-valid) on the train phase's
    epoch_2.npz at full width: the train corpus's 16 valid utterances as the
    test set, 8 K1 launches a batch, test/epoch_2/synth/ with one wav per
    utterance and test/epoch_2/metrics.json. Returns K1's launches."""
    from morgana_tpu_torch.data import file_io
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.ops import lstm as lstm_ops

    data_root, _ = train_corpus(root)
    exp_base = os.path.join(root, 'experiments')
    ckpt = os.path.join(exp_base, 'train', 'checkpoints', 'epoch_2.npz')
    args = ExperimentBuilder.get_experiment_args([
        '--experiment_name', 'builder_test', '--experiments_base', exp_base,
        '--data_root', data_root, '--checkpoint_path', ckpt, '--no-train', '--no-valid',
        '--test', '--test_dir', 'valid', '--test_id_list', 'valid/valid_file_id_list.scp'])
    exp = ExperimentBuilder(LSTMAcousticModel, **args)
    batches = len(exp.test_loader)
    torch.cuda.synchronize()
    lstm_ops.launches = 0
    start = time.perf_counter()
    with timed_wav_writes() as writes:
        exp.run_experiment()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    launches = lstm_ops.launches
    if launches != 8 * batches:
        raise AssertionError(f'builder_test: K1 launched {launches} times for {batches} batches')
    ids = file_io.get_file_ids(os.path.join(data_root, 'valid', 'valid_file_id_list.scp'))
    lengths = {utt: int(np.loadtxt(os.path.join(data_root, 'valid', 'n_frames', f'{utt}.txt')))
               for utt in ids}
    test_dir = os.path.join(exp_base, 'builder_test', 'test', 'epoch_2')
    check_wavs('builder_test', os.path.join(test_dir, 'synth'), lengths)
    if not os.path.exists(os.path.join(test_dir, 'metrics.json')):
        raise AssertionError('builder_test: test/epoch_2/metrics.json was not written')
    emit({'phase': 'builder_test', 'card': smi, 'checkpoint': 'train/checkpoints/epoch_2.npz',
          'utterances': len(ids), 'batches': batches, 'run_seconds': run_s,
          'wav_write_seconds': writes['seconds'], 'k1_launches': launches,
          'k1_launches_expected': 8 * batches})
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser(description='Smoke test of the port on one NVIDIA GPU; '
                                     'with no arguments, every phase.')
    parser.add_argument('--attention-parent', metavar='DIR',
                        help='only time the attention kernels of DIR (a tree holding '
                        'morgana_tpu_torch/csrc, e.g. a git archive of the parent commit) '
                        "beside this tree's, in turns, and stop")
    parser.add_argument('--transformer-only', action='store_true',
                        help='only the Transformer serving and training phases (copied into '
                        "another tree's root, this gives that tree's end-to-end numbers)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 2
    from morgana_tpu_torch import _build
    from morgana_tpu_torch.models.f0_test_model import F0Model
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({'phase': 'device', 'nvidia_smi': smi, 'name': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'python': sys.version.split()[0],
          'tf32_matmul': False, 'tf32_cudnn': False})

    # Every kernel, and the LSTM kernels' step_split build, one nvcc each, all
    # started together.
    start = time.perf_counter()
    only = args.attention_parent or args.transformer_only
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        split_build = None if only else pool.submit(_build.build, ['lstm_fwd', 'lstm_bwd'],
                                                    'step_split')
        paths = _build.build(['attn_fwd', 'attn_bwd'] if only else None)
        if split_build is not None:
            split_build.result()
    logs = {}
    for name, path in paths.items():
        with open(os.path.splitext(path)[0] + '.log') as f:
            logs[name] = [line.strip() for line in f if 'Used' in line or 'spill' in line]
    emit({'phase': 'build', 'seconds': time.perf_counter() - start,
          'kernels': {k: os.path.relpath(v) for k, v in paths.items()}, 'ptxas': logs})
    if not only:
        vocoder_native_phase(smi)

    dev = torch.device('cuda')
    if only:
        if args.attention_parent:
            attention_parent_phase(torch, dev, args.attention_parent)
        else:
            with tempfile.TemporaryDirectory() as root:
                transformer_serving_phase(torch, root)
                transformer_train_phase(torch, root)
        print(nvidia_smi(), flush=True)
        return 0

    # Where the LSTM kernels' step goes.
    lstm_step_split_phase(torch, dev)

    # K1 against its plain version and cuDNN: B=32 (the training batch), the
    # serving path's shape, and edge shapes (T=1, B not a multiple of 32,
    # two 32-row slices, B = 88, 128 and 256, which a K1 staging all of h
    # in shared memory could not take); then the same with bf16 storage (K1s).
    k1_case(torch, dev, 32, 1024, True, 1, timed=True)
    k1_case(torch, dev, 32, 1024, False, 2, timed=True)
    main_shape = k1_case(torch, dev, SERVE_BATCH, 1024, False, 3, timed=True)
    for batch, steps in ((5, 1), (1, 17), (40, 33), (88, 17), (128, 17), (256, 9)):
        k1_case(torch, dev, batch, steps, True, 4, timed=False)
    k1_case(torch, dev, 32, 1024, True, 81, timed=True, store='bfloat16')
    bf16_shape = k1_case(torch, dev, SERVE_BATCH, 1024, False, 82, timed=True, store='bfloat16')
    for batch, steps in ((5, 1), (1, 17), (40, 33), (88, 17), (128, 17)):
        k1_case(torch, dev, batch, steps, True, 83, timed=False, store='bfloat16')

    # K1 with gates and K2 at the training shape, with and without an
    # initial state, and at the edge shapes; then with bf16 storage.
    train_shape = k2_case(torch, dev, TRAIN_BATCH, 1024, False, 5, timed=True)
    k2_case(torch, dev, TRAIN_BATCH, 1024, True, 6, timed=True)
    for batch, steps in ((5, 1), (1, 17), (40, 33), (88, 17), (128, 9)):
        k2_case(torch, dev, batch, steps, True, 7, timed=False)
    bf16_train_shape = k2_case(torch, dev, TRAIN_BATCH, 1024, False, 84, timed=True,
                               store='bfloat16')
    k2_case(torch, dev, SERVE_BATCH, 1024, True, 85, timed=False, store='bfloat16')
    for batch, steps in ((5, 1), (40, 33), (88, 17)):
        k2_case(torch, dev, batch, steps, True, 86, timed=False, store='bfloat16')

    # K3 against its plain version and cuDNN at F0Model's widths (H=64, B=32
    # the training batch, B=16 the serving one, T=1024) and DurationModel's
    # (H=128, B=32, T=128), with and without h0; then edge shapes: T=0, T=1,
    # B=1, 5, 40 and 256, rows of length 0 and 1.
    k3_case(torch, dev, TRAIN_BATCH, 1024, 64, 256, True, 31, timed=True)
    k3_case(torch, dev, TRAIN_BATCH, 1024, 64, 256, False, 32, timed=True)
    gru_fwd_shape = k3_case(torch, dev, SERVE_BATCH, 1024, 64, 256, False, 33, timed=True)
    for with_state in (True, False):
        k3_case(torch, dev, TRAIN_BATCH, 128, 128, 128, with_state, 34, timed=True)
    edges = ((1, 17), (5, 1), (40, 33), (256, 9), (16, 0))
    for hidden in (64, 128):
        for batch, steps in edges:
            k3_case(torch, dev, batch, steps, hidden, hidden, True, 35, timed=False)

    # K3 then K4 against autograd through the plain loop, at the same shapes.
    gru_bwd_shape = k4_case(torch, dev, TRAIN_BATCH, 1024, 64, 256, False, 36, timed=True)
    k4_case(torch, dev, TRAIN_BATCH, 1024, 64, 256, True, 37, timed=True)
    k4_case(torch, dev, TRAIN_BATCH, 128, 128, 128, True, 38, timed=True)
    for hidden in (64, 128):
        for batch, steps in edges:
            k4_case(torch, dev, batch, steps, hidden, hidden, True, 39, timed=False)
    gru_step_sweep(torch, dev, 42)

    # The attention forward against its plain version and SDPA at the
    # Transformer's heads (H4, dh 96; B16 the serving batch, B32 the training
    # one, T1024, ragged seq_len): full, causal, causal with the default
    # window 256; the other widths dh 64 and 128; then edge shapes (T = 1,
    # T = 77, B = 1, a row of length 0, padded rows past a small window), and
    # K6's entry point, MultiHeadAttention(backend='flash').
    attn_fwd_shape = k5_case(torch, dev, SERVE_BATCH, 4, 1024, 96, False, None, 51, timed=True)
    for causal, window in ((False, None), (True, None), (True, 256)):
        k5_case(torch, dev, TRAIN_BATCH, 4, 1024, 96, causal, window, 52, timed=True)
    for head_dim in (64, 128):
        k5_case(torch, dev, TRAIN_BATCH, 4, 1024, head_dim, False, None, 53, timed=True)
    attn_edges = ((4, 1, 96, False, None, False), (3, 77, 96, False, None, True),
                  (1, 77, 96, True, None, False), (3, 77, 96, True, 8, True),
                  (2, 200, 64, True, 16, True), (3, 130, 128, False, None, True))
    for batch, steps, head_dim, causal, window, empty in attn_edges:
        k5_case(torch, dev, batch, 4, steps, head_dim, causal, window, 54, timed=False,
                empty_row=empty)
    k6_case(torch, dev, 55)

    # The attention backward against autograd through the plain version, at
    # the same shapes.
    attn_bwd_shape = k5_bwd_case(torch, dev, TRAIN_BATCH, 4, 1024, 96, False, None, 56, timed=True)
    k5_bwd_case(torch, dev, TRAIN_BATCH, 4, 1024, 96, True, None, 57, timed=True)
    k5_bwd_case(torch, dev, TRAIN_BATCH, 4, 1024, 96, True, 256, 58, timed=True)
    for head_dim in (64, 128):
        k5_bwd_case(torch, dev, TRAIN_BATCH, 4, 1024, head_dim, False, None, 59, timed=True)
    for batch, steps, head_dim, causal, window, empty in attn_edges:
        k5_bwd_case(torch, dev, batch, 4, steps, head_dim, causal, window, 60, timed=False,
                    empty_row=empty)

    with tempfile.TemporaryDirectory() as root:
        serve_launches, _, served = serving_phase(torch, root)
        vocoder_batch_phase(torch, dev, served, smi)
        generate_launches = generate_lstm_phase(torch, served, smi)
        train_launches = train_phase(torch, root)
        test_launches = builder_test_phase(torch, root, smi)
        _, bf16_serve_launches, _ = serving_phase(torch, root, 'serve_bf16', 'bfloat16')
        bf16_train_launches = train_phase(torch, root, 'train_bf16', 'bfloat16')
        train_parity_phase(torch, root, LSTMAcousticModel)
        f0_serve_launches = f0_serving_phase(torch, root)
        f0_train_launches = f0_train_phase(torch, root, smi)
        train_parity_phase(torch, root, F0Model, 'f0_train_parity', 23)
        duration_launches = duration_train_phase(torch, root)
        attn_serve_launches = transformer_serving_phase(torch, root)
        attn_train_launches = transformer_train_phase(torch, root)
        train_parity_phase(torch, root, TransformerAcousticModel, 'transformer_train_parity', 24,
                           '--learning_rate', TRANSFORMER_LR)
        transformer_dropout_phase(torch, root)
    if not (serve_launches and generate_launches and test_launches
            and train_launches['k1_gates'] and train_launches['k2']
            and bf16_serve_launches and bf16_train_launches['k1_bf16']
            and bf16_train_launches['k2_bf16']
            and f0_serve_launches and f0_train_launches['k3'] and f0_train_launches['k4']
            and duration_launches['k3'] and duration_launches['k4']
            and attn_serve_launches and attn_train_launches['attn_fwd']
            and attn_train_launches['attn_bwd']):
        raise AssertionError('a kernel of the main path was not launched')

    # launches: the main paths' runs, each counted from 0: serving,
    # generation (generate_lstm, builder_test) and training for the LSTM
    # kernels; F0Model serving and training and
    # DurationModel training for the GRU kernels; TransformerAcousticModel
    # serving and training for the attention kernels. The forward kernels'
    # numbers are at the serving shape (B=16), the backward ones' at the
    # training one (B=32).
    emit({'kernels': [{
        'name': 'lstm_fwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/lstm_fwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_rnn.py:77',
        'launches': serve_launches + generate_launches + test_launches + train_launches['k1'],
        'max_abs_err': main_shape['max_abs_err_vs_plain'], 'ms': main_shape['kernel_ms'],
        'plain_ms': main_shape['plain_ms'], 'bound_ms': main_shape['bound_ms'],
        'bound_by': main_shape['bound_by'], 'library_ms': main_shape['library_ms']}, {
        'name': 'lstm_bwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/lstm_bwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_rnn.py:113', 'launches': train_launches['k2'],
        'max_abs_err': train_shape['k2_max_abs_err'], 'ms': train_shape['kernel_ms'],
        'plain_ms': train_shape['plain_ms'], 'bound_ms': train_shape['bound_ms'],
        'bound_by': train_shape['bound_by'], 'library_ms': train_shape['library_ms']}, {
        'name': 'lstm_fwd_bf16', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/lstm_fwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_rnn.py:176',
        'launches': bf16_serve_launches + bf16_train_launches['k1_bf16'],
        'max_abs_err': bf16_shape['max_abs_err_vs_plain'], 'ms': bf16_shape['kernel_ms'],
        'plain_ms': bf16_shape['plain_ms'], 'bound_ms': bf16_shape['bound_ms'],
        'bound_by': bf16_shape['bound_by'], 'library_ms': bf16_shape['library_ms']}, {
        'name': 'lstm_bwd_bf16', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/lstm_bwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_rnn.py:176',
        'launches': bf16_train_launches['k2_bf16'],
        'max_abs_err': bf16_train_shape['k2_max_abs_err'], 'ms': bf16_train_shape['kernel_ms'],
        'plain_ms': bf16_train_shape['plain_ms'], 'bound_ms': bf16_train_shape['bound_ms'],
        'bound_by': bf16_train_shape['bound_by'],
        'library_ms': bf16_train_shape['library_ms']}, {
        'name': 'gru_fwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/gru_fwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_gru.py:35',
        'launches': f0_serve_launches + f0_train_launches['k3'] + duration_launches['k3'],
        'max_abs_err': gru_fwd_shape['max_abs_err_vs_plain'], 'ms': gru_fwd_shape['kernel_ms'],
        'plain_ms': gru_fwd_shape['plain_ms'], 'bound_ms': gru_fwd_shape['bound_ms'],
        'bound_by': gru_fwd_shape['bound_by'], 'library_ms': gru_fwd_shape['library_ms']}, {
        'name': 'gru_bwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/gru_bwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_gru.py:59',
        'launches': f0_train_launches['k4'] + duration_launches['k4'],
        'max_abs_err': gru_bwd_shape['k4_max_abs_err'], 'ms': gru_bwd_shape['kernel_ms'],
        'plain_ms': gru_bwd_shape['plain_ms'], 'bound_ms': gru_bwd_shape['bound_ms'],
        'bound_by': gru_bwd_shape['bound_by'], 'library_ms': gru_bwd_shape['library_ms'],
        'layer_fwd_bwd_ms': gru_bwd_shape['layer_fwd_bwd_ms'],
        'hg_gemm_ms': gru_bwd_shape['hg_gemm_ms']}, {
        'name': 'attn_fwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/attn_fwd.cu',
        'replaces': 'morgana_tpu/nn.py:1001', 'also_replaces': 'morgana_tpu/nn.py:1055',
        'launches': attn_serve_launches + attn_train_launches['attn_fwd'],
        'max_abs_err': attn_fwd_shape['max_abs_err_vs_plain'], 'ms': attn_fwd_shape['kernel_ms'],
        'plain_ms': attn_fwd_shape['plain_ms'], 'bound_ms': attn_fwd_shape['bound_ms'],
        'bound_by': attn_fwd_shape['bound_by'], 'library_ms': attn_fwd_shape['library_ms'],
        'simt_bound_ms': attn_fwd_shape['simt_bound_ms']}, {
        'name': 'attn_bwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/attn_bwd.cu',
        'replaces': 'morgana_tpu/nn.py:1001', 'also_replaces': 'morgana_tpu/nn.py:1055',
        'launches': attn_train_launches['attn_bwd'],
        'max_abs_err': attn_bwd_shape['bwd_max_abs_err'], 'ms': attn_bwd_shape['kernel_ms'],
        'plain_ms': attn_bwd_shape['plain_ms'], 'bound_ms': attn_bwd_shape['bound_ms'],
        'bound_by': attn_bwd_shape['bound_by'], 'library_ms': attn_bwd_shape['library_ms'],
        'simt_bound_ms': attn_bwd_shape['simt_bound_ms']}]})
    print(nvidia_smi(), flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
