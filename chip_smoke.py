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
   line once. pipeline_lstm: speech from the 32 utterances' labels,
   TTSPipeline with a seeded full-width DurationModel (600 -> 128 ->
   GRU(128) -> 1, about 8 frames a phone) before the same
   LSTMAcousticModel, B16, with the host vocoder and then with
   device_vocoder=True (one torch_world.synthesize_batch on the card): 1 K3
   and 8 K1 launches a batch, 32 wavs each time, durations and features
   against the CPU pipeline, the device vocoder bit-identical when called
   again and against the CPU on its inputs; utt/s, frames/s, audio
   seconds/s and the split (duration stage, acoustic stage, vocoder,
   writes) of both routes; then the pipeline's command line with
   --device_vocoder and --evaluate_against. stream_lstm:
   TTSPipeline.stream_audio on the 4 utterances with the most phones at
   (chunk 64, context 32, lookahead 16): 1 K3 launch, then 8 K1 launches a
   chunk with the carried state; every chunk's network outputs and the
   streamed features against the same card engine's batch predict, one
   utterance against the CPU stream, one K1 chunk (B1, T64, with state)
   against its plain version (k1_stream_chunk); time to the first audio,
   ms a chunk (model, MLPG, vocoder), real-time factor.
   stream_transformer: the causal TransformerAcousticModel (window 256) at
   its default widths: the 4 longest utterances in one batch (6 attention
   launches) and streamed through the KV caches (no kernel launch): the
   network outputs against the batch, one utterance against the CPU
   stream; ms a chunk and frames/s. http_serve: http_serve.make_server on
   127.0.0.1 over the same checkpoint, dynamic batching 5 ms: 32 sequential
   one-utterance /predict (8 K1 launches each, replies against the
   engine's predict_items), 32 concurrent clients (dispatch groups, padded
   rows, where a request's seconds go: JSON decode, predict, JSON encode),
   /stream with audio on the longest (samples equal to stream_item_audio's,
   time to the first line), a hot reload under 8 posting clients (no error,
   /healthz switched within 2 s, a stream paused across the switch ends on
   the old weights) and a fleet {lstm, f0, transformer} (8 K1, 3 K3, 6
   attention launches, an unknown voice 404). quantize_serve: the engine in
   int8 and int4 on the 32 utterances against the CPU engine in the same
   mode, its error against f32, its device bytes against f32 (nothing left
   resident by a call), frames/s; then python -m morgana_tpu_torch.quantize
   and the engine detecting its output, bit-identical to quantize='int8'.
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
   per-step losses and the first step's gradients. It, and the builder
   phase's optimiser and --log_norms cases, run the host data path
   (HOST_PATH) on both sides; every other builder run here takes the
   card's defaults (the device cache and device-side normalisation).
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

20. mlpg_kernel (before the main paths): MLPG (csrc/mlpg.cu) at B16 T1024
    with padding 100, the LSTM's three streams (66 static features, 1,056
    lanes) and F0Model's one: the solve alone (morgana::mlpg_solve) on the
    systems banded_system builds, against its plain loop on the same card
    inputs, and the whole of MLPG (morgana::mlpg: the build, the loop's
    factor, the float64 substitutions partitioned along time and the unpad
    in one launch) against the plain path; each within
    MLPG_RTOL and, against a float64 solve of the same systems, within
    twice the loop's own error plus an ulp; one launch each, and one device
    kernel in all a mlpg() call (the profiler: only the MLPG kernel in 10
    calls); device ms beside the bound,
    the loop, the dense torch.linalg.solve and, by host clock, the whole
    mlpg() and the old route; mlpg() against the CPU. Every serving and
    training phase's MLPG runs through morgana::mlpg: the serving phases
    count one launch a batch, every phase reports its MLPG launches and
    mlpg_ms a batch beside frames/s and the idle share.
21. export (after quantize_serve): export_bundle of the serving phase's
    LSTMAcousticModel at B16 over the 32 utterances (a program a bucket)
    and of one bucket each of seeded TransformerAcousticModel and F0Model
    voices; a fresh process that imports no model module runs them with
    ExportedVoice: outputs equal to the engine's (EXPORT_RTOL), 8 K1 / 6
    attention / 3 K3 launches and one MLPG solve a batch inside the loaded
    programs; export seconds, program and params bytes, the first-call
    latency of the bundle's process against a fresh engine's.
22. compilation_cache: the serving command line twice in fresh processes
    with --compilation_cache_dir: the first runs nvcc for K1 and the solve
    and g++ for the vocoder into the directory, the second runs no
    compiler; both launch the kernels and write the wavs.
23. bf16_kernels (after mlpg_kernel): the bf16-compute kernels (the serving
    path of --compute_dtype bfloat16) against their plain versions with the
    same rounding, on the card: K1c (f32 storage, bf16 products) at B16
    T1024 H512 and at B1 T64 with the carried state of a stream, K3c at H64
    B16 T1024 and H128 B32 T128, K5b (bf16 q, k and v, f32 o;
    csrc/attn_fwd_bf16.cu, wgmma fed by TMA) at B16 and B32 H4 T1024 dh 96
    with full, causal, windowed and empty-row masks (its device time by the
    profiler beside the events' time), and edge
    shapes: each output within BF16_ULPS bf16 ulps and closer in mean to
    the bf16 plain version than to the f32 one (hold_bf16); times beside
    the plain versions, cuDNN's LSTM and GRU in bf16, SDPA on bf16 q, k, v
    and the bounds (bf16 tensor-core peak, 3.35 TB/s).
24. bf16_serving (after the other main paths): LSTMAcousticModel (the serving phase's
    checkpoint), F0Model, TransformerAcousticModel and its causal form
    served by an f32 and a bf16 engine in turns: K1c, K3c or K5b on every
    bf16 batch and no f32 kernel, the bf16 card engine against the bf16
    CPU engine (and closer to it than the f32 card engine), frames/s, ms a
    batch, peak memory, device busy time and idle share beside the f32
    engine's; the LSTM and causal Transformer streams in bf16; one LSTM
    bundle exported in bf16 and run in a fresh process; the pipeline's
    command line with --compute_dtype bfloat16 and the card's vocoder.
25. bf16_backward (after bf16_kernels): the backward kernels of
    --compute_dtype bfloat16 training against their plain versions on the
    card: the LSTM layer's gradient path (K1c with its f32 gate trace, K2c,
    the bf16 weight-gradient carry) at B32 T1024 H512 (k2c), the GRU's (K3c,
    K4c, the carry) at H64 B32 T1024 and H128 B32 T128 (k4c), and K5b's
    backward at B32 H4 T1024 dh 96, full, causal and windowed (k5b_bwd),
    with edge shapes: every gradient and each kernel alone within BF16_ULPS
    bf16 ulps and closer in the mean to the bf16 plain version than to the
    f32 one; times beside the plain versions, the f32 kernels, the bounds,
    cuDNN's LSTM and GRU forward+backward in bf16 and SDPA's forward+backward
    on bf16 q, k and v.
26. bf16_training (last): LSTMAcousticModel (scan backend, full width),
    F0Model, DurationModel and TransformerAcousticModel (lr 0.001) trained
    for 2 epochs (B=32) through the ExperimentBuilder in f32 and then with
    --compute_dtype bfloat16, one turn each: the bf16 run launches only the
    bf16 builds, as many as its layers and steps give, and writes
    compute_dtype to config.json; ms a step, frames/s, peak memory, device
    busy time and idle share of both runs (bf16_train_<model> lines); then
    3 steps of B=4 on the card against the CPU bf16 trainer
    (bf16_train_parity_<model>: losses within TRAIN_LOSS_RTOL, the first
    step's gradients within BF16_ULPS bf16 ulps of each one's max).
27. builder (after families): the rest of the voice builder's training loop
    on LSTMAcousticModel at full width (f32, TF32 off) from a seeded
    epoch_0.npz, through ExperimentBuilder: adamw, sgd (momentum 0.9,
    Nesterov) and lamb for 3 steps of B4 on the card against the CPU port
    (losses within TRAIN_LOSS_RTOL, the 3 steps' parameter change within
    OPT_PARAM_RTOL); --grad_accum_steps 2 at B16 against one B32 step of
    the same 32 utterances (SGD; ACCUM_RTOL; 8 K1 with gates and 8 K2 a
    micro-batch); --log_norms on the card against the CPU at B4
    (NORMS_RTOL); the exact resume (--step_checkpoint_interval 1
    --length_sort_window 2 --num_data_threads 4 --keep_checkpoints 1, an
    interrupt in epoch 2, then --checkpoint_path latest) against an
    uninterrupted run, after two uninterrupted runs show whether the card
    is bit-reproducible; --config replaying the first loss; --find_lr
    1e-5,1,12; --search_batch_size at SEARCH_LIMIT_GIB with a step at the
    size found; --memory_report and --profile_dir in a fresh builder process
    (K1 and K2 in the trace, 8 a step); --debug_nans; --compilation_cache_dir (two builder processes:
    the libraries appear, the second runs no nvcc); metrics.pdf. Timed
    beside them: ms an applied update with and without accumulation, ms a
    step of each optimiser and of Adam, the step checkpoint's save seconds
    and --log_norms' cost.
28. fast_path (last): the builder's device-side fast path on the card, on
    a corpus of 8 B32 batches of one shape (60 phones of 5 frames an
    utterance) and one valid batch: the GPU defaults (--device_cache and
    --device_normalise on, --steps_per_dispatch 1 after a dispatch
    round-trip probe under 5 ms) and the native batch reader in use; the
    cache's batches bit for bit the collated ones on the card, and with
    the device transform the raw and delta keys bit for bit and the
    normalised ones within FAST_ULPS of the host path; an epoch of the
    defaults (the main path); two epochs with validation at
    --steps_per_dispatch 8 (CUDA graph replays) bit-identical in losses,
    parameters and metrics to --steps_per_dispatch 1, for the full-width
    LSTM (f32 and bf16: K1/K2's cooperative launches and K1c/K2c's cluster
    launches captured) and DurationModel (K3/K4's clusters of two at H128);
    in a fresh process (FAST_PATH_RUN) the profiler's kernels a replayed
    step (8 K1 and 8 K2, in bf16 8 K1c and 8 K2c; 1 K3 and 1 K4, in bf16 1
    K3c and 1 K4c) and ms a step, busy and idle of per-batch eager steps,
    cache-assembled eager steps and graphs of 8 (the LSTM and Duration, in
    f32 and bf16), graphs captured and capture seconds; --remat
    gradients bit for bit those without it and the step's peak memory
    lower (the LSTM, the Transformer); the bytes a batch moves on the link
    (host path, device normalisation, bf16 wire, cache); LSTM epochs at
    B16 with and without the prefetch at 0 and 4 loader threads, in turns.
    The kernels' launch counters count a captured step once, not its
    replays: the profiler counts a replayed step's kernels.

Then a line {"kernels": [...]} with each kernel's numbers at its main
path's shape, the nvidia-smi line, and last {"ok": true, "device": {...}}.
The vocoder holds no kernel (the JAX package's is plain XLA), so it has no
entry there; its phases' lines carry the card's name and power limit.
Needs no network and writes only to a temporary directory. The profiler's
device-time tables go to stderr.

Two other modes, each after the device and build phases: --kernel-parent
DIR times the attention kernels, the bf16 carry and MLPG's solve of another
tree (DIR holds its morgana_tpu_torch/csrc, e.g. a git archive of the
parent commit) beside this tree's, in turns, at the k5 / k5_bwd / k5b_bwd
main shapes, the LSTM, F0 and Duration carries and mlpg_kernel's systems,
this tree's whole mlpg() beside the parent's route to the same
trajectory, the bf16 LSTM and GRU kernels beside the parent's builds, K5b's
forward beside the parent's (B16 full, B32 full, causal and window 256,
device ms by the profiler and SDPA's time), and the bf16 Transformer's
serving batch and train step with the parent's K5b in place of this
tree's (kernel_parent_compare);
--transformer-only runs phases 16 and 17 alone: copied into another tree's
root, it gives that tree's end-to-end numbers; --families-only runs
families_phase, --builder-only builder_phase and --fast-path-only
fast_path_phase alone.
"""
import argparse
import base64
import concurrent.futures
import contextlib
import json
import math
import os
import shutil
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
# MLPG (csrc/mlpg.cu) against its plain loop on the card, relative to the
# largest |x|. The kernel takes the loop's factor but substitutes in
# float64 (partitioned along time), so it is also held to a float64 solve of
# the same systems: its max and mean error at most twice the loop's own plus
# one f32 ulp (mlpg_errors).
MLPG_RTOL = 1e-6
MLPG_PADDING = 100          # the acoustic models' burn-in (models/rnn_spss.py:119)
MLPG_FEATS = {'lstm': 1 + 60 + 5, 'f0': 1}   # static features a stream group solves
# An exported program against the engine it came from: the same kernels on
# the same inputs, relative to each output's largest |value|.
EXPORT_RTOL = 1e-6
SERVE_BATCH = 16
N_UTTS = 32
TRAIN_BATCH = 32
F0_LAYERS = 3       # F0Model: 3 x GRU(64)
TRANSFORMER_BLOCKS = 6      # TransformerAcousticModel's defaults
TRANSFORMER_LR = '0.001'    # the learning rate its JAX docstring recommends
# The other model families at their defaults: MultiSpeakerF0Model over 4
# speakers, VAEProsodyModel (its 2 GRU layers in a train step, the decoder's
# alone in predict), ConvAcousticModel (6 blocks) and the Transformer with 8
# experts in blocks 2, 4 and 6 (Switch Transformer's smallest sparse
# configuration; the repo gives no count).
SPEAKERS = ('spk_0', 'spk_1', 'spk_2', 'spk_3')
# A mixture-of-experts block sends each token to its most probable expert.
# Under bf16 two right engines can route a near tie apart (their router
# inputs differ by bf16 roundings), and that batch row's outputs then differ
# by an expert's output. So a bf16 MoE engine is held row by row (rows are
# independent): a row routed alike in every block in full, a row routed
# apart only where, at the first block that routes it apart, the two
# experts' probabilities are within ROUTE_TIE of each other on both engines.
ROUTE_TIE = 2.0 ** -7
VAE_LATENT_SAMPLES = 4      # VAEProsodyModel.analysis_for_test_batch's default
CONV_BLOCKS = 6
MOE_KWARGS = {'moe_experts': 8}
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
# The two-stage pipeline and the stream (pipeline_lstm, stream_lstm,
# stream_transformer). DurationModel's dur statistics put about 8 frames on
# a phone, as make_items' durations do. The stream runs at the serving
# configuration (chunk, context, lookahead) on the STREAM_UTTS longest
# utterances; its smoothed trajectories within JAX's own streamed-against-
# batch atol of the same engine's batch predict (tests/test_streaming.py:493;
# the LSTM stays within 1.5e-6 of it on the CPU at full width, its seeded
# outputs being smooth).
PIPELINE_DUR_STATS = {'mean': [8.0], 'std_dev': [2.0]}
PIPELINE_DUR_SEED = 44
STREAM_CONFIG = (64, 32, 16)
STREAM_UTTS = 4
STREAM_TRAJ_ATOL = {'lf0': 1e-4, 'mcep': 1e-3, 'bap': 1e-3}
# The HTTP server (http_serve): replies against the same engine's
# predict_items within JAX's batched-against-single tolerance
# (tests/test_serve.py:431-435); a stream that a reload lands in, against
# the old weights' stream, within STREAM_PIN_RTOL of each output's largest
# |value| (the same weights and kernels: equal but for the order of host
# sums); the reload seen by /healthz within RELOAD_DEADLINE s of the file's
# rename at a RELOAD_WATCH s poll, under RELOAD_CLIENTS posting clients.
HTTP_RTOL = 2e-4
HTTP_ATOL = 2e-5
HTTP_BATCH_MS = 5.0
HTTP_TIMEOUT = 120
STREAM_PIN_RTOL = 1e-5
RELOAD_CLIENTS = 8
RELOAD_WATCH = 0.2
RELOAD_DEADLINE = 2.0
# Quantized serving (quantize_serve): the card engine against the CPU engine
# in the same mode within QUANT_RTOL relative L2 (both dequantise the same
# q * scale); the model's device bytes at most QUANT_BYTES_BOUND of the f32
# model's (int8: 1 byte a weight and an f32 scale a column; int4: half a
# byte and an f32 scale per 64 rows a column). JAX's bounds against the
# float engine at its test sizes (tests/test_quantize.py:183, :465), written
# beside the full-width numbers, not held.
QUANT_RTOL = 1e-4
QUANT_BYTES_BOUND = {'int8': 0.26, 'int4': 0.15}
JAX_QUANT_BOUND = {'int8': 2e-2, 'int4': 0.15}
# A stream's network outputs, held to the batch predict's within NET_TOL.
NET_OUTPUTS = ('normalised_lf0_deltas', 'normalised_mcep_deltas', 'normalised_bap_deltas', 'vuv')
# The acoustic models' served outputs and their widths.
ACOUSTIC_DIMS = {'normalised_lf0_deltas': 3, 'normalised_mcep_deltas': 180,
                 'normalised_bap_deltas': 15, 'lf0': 1, 'vuv': 1, 'mcep': 60, 'bap': 5}


_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also says when it ended (elapsed_s, seconds
    since the script started), so that the script's time splits by phase."""
    if 'phase' in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - _START)
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


def k1_bound(batch, time_steps, hidden, gates=False, store=None, compute=None):
    """Least time for the recurrence: 2*B*H*4H flops per step against the
    peak of the inputs' type (f32, or bf16's tensor-core rate with bf16
    storage or a bf16 `compute` type, K1c), and xg read plus y and c_all
    written (with w_hh read; with `gates`, g_all (T, B, 4H) written too) in
    the storage type, h0, c0 read and hn, cn written in f32, against the
    memory rate."""
    size = 2 if store == 'bfloat16' else 4
    peak = BF16_PEAK_FLOPS if 'bfloat16' in (store, compute) else F32_PEAK_FLOPS
    flops = 2.0 * batch * hidden * 4 * hidden * time_steps
    nbytes = size * ((2 if gates else 1) * time_steps * batch * 4 * hidden
                     + 2 * time_steps * batch * hidden + hidden * 4 * hidden) \
        + 4.0 * 4 * batch * hidden
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def mixed_product_ms(flops):
    """Least time for products of a bf16 operand and an f32 one with f32
    sums: three bf16 passes on the tensor cores (the f32 operand split into
    three bf16 planes that add back to it exactly; each plane times a bf16
    value is exact in f32) at the bf16 peak, 3/4 of the time of two TF32
    passes. The bounds of K2c, K4c, the carry and K5b's backward count such
    products so."""
    return 3.0 * flops / BF16_PEAK_FLOPS * 1e3


def k2_bound(batch, time_steps, hidden, store=None, compute=None):
    """Least time for the backward recurrence: 2*B*4H*H flops per step
    (dh = dxg @ w_hh^T) against the peak of the inputs' type, and g_all read
    plus dxg written, c_all, dy and dc_all read (with w_hh and c0 read) in
    the storage type, dhn, dcn read and dh0, dc0 written in f32, against the
    memory rate. With a bf16 `compute` type (K2c) w_hh is read as bf16 and
    the product, whose gate gradients are f32, counts as mixed_product_ms."""
    size, peak = (2, BF16_PEAK_FLOPS) if store == 'bfloat16' else (4, F32_PEAK_FLOPS)
    flops = 2.0 * batch * 4 * hidden * hidden * time_steps
    w_size = 2 if compute == 'bfloat16' else size
    nbytes = size * (2 * time_steps * batch * 4 * hidden + 3 * time_steps * batch * hidden
                     + batch * hidden) + w_size * hidden * 4 * hidden + 4.0 * 4 * batch * hidden
    ops_ms = mixed_product_ms(flops) if compute == 'bfloat16' else flops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def k3_bound(batch, time_steps, hidden, compute=None):
    """Least time for the GRU recurrence: 2*B*H*3H flops per step against the
    float32 peak (the bf16 tensor-core peak with a bf16 `compute` type,
    K3c), and xg (T, B, 3H) read plus y written (with w_hh, b_hh and h0 read
    and hn written) in f32 against the memory rate."""
    flops = 2.0 * batch * hidden * 3 * hidden * time_steps
    nbytes = 4.0 * (time_steps * batch * 3 * hidden + time_steps * batch * hidden
                    + hidden * 3 * hidden + 3 * hidden + 2 * batch * hidden)
    peak = BF16_PEAK_FLOPS if compute == 'bfloat16' else F32_PEAK_FLOPS
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def k4_bound(batch, time_steps, hidden, compute=None):
    """Least time for the GRU backward recurrence given hg: one product of
    2*B*3H*H flops per step (the carry through w_hh^T) against the float32
    peak, and xg and hg read plus dxg written, y and dy read plus dnr
    (da_n * r) written (with w_hh, h0 and dhn read and dh0 written) against
    the memory rate. The hg GEMM is timed apart (hg_gemm_ms). With a bf16
    `compute` type (K4c) w_hh is read as bf16 and the product, whose gate
    gradients are f32, counts as mixed_product_ms."""
    flops = 2.0 * batch * hidden * 3 * hidden * time_steps
    nbytes = 4.0 * (3 * time_steps * batch * 3 * hidden + 3 * time_steps * batch * hidden
                    + 3 * batch * hidden) \
        + (2 if compute == 'bfloat16' else 4) * hidden * 3 * hidden
    ops_ms = mixed_product_ms(flops) if compute == 'bfloat16' else flops / F32_PEAK_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def carry_bound(batch, time_steps, hidden, gates):
    """Least time for the bf16 weight-gradient carry: H*G*T*B multiply-adds
    (2 flops each) of f32 gate gradients by bf16 states, summed in f32, as
    mixed_product_ms (each step's product of depth B on the tensor cores,
    three bf16 passes, rounded before it joins the carry), against h_prev
    (T, B, H) and dg (T, B, G) read and dW (H, G) written in f32 at the
    memory rate."""
    flops = 2.0 * hidden * gates * time_steps * batch
    nbytes = 4.0 * (time_steps * batch * (hidden + gates) + hidden * gates)
    ops_ms, bytes_ms = mixed_product_ms(flops), nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def layer_inputs(torch, dev, batch, time_steps, with_state, seed, hidden=H):
    """Seeded inputs of one LSTM(hidden) layer (input width `hidden` too):
    x, the four weights, a ragged seq_len (one row of T, one of 1) and an
    optional initial state."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / math.sqrt(hidden)

    def uniform(*shape):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32)).to(dev)

    x = torch.from_numpy(rng.normal(size=(batch, time_steps, hidden)).astype(np.float32)).to(dev)
    weights = [uniform(hidden, 4 * hidden), uniform(hidden, 4 * hidden), uniform(4 * hidden),
               uniform(4 * hidden)]
    seq_len = rng.integers(1, time_steps + 1, batch)
    seq_len[0] = time_steps
    seq_len[-1] = 1
    seq_len = torch.from_numpy(seq_len).to(dev)
    h0 = c0 = None
    if with_state:
        h0 = torch.from_numpy(0.5 * rng.normal(size=(batch, hidden)).astype(np.float32)).to(dev)
        c0 = torch.from_numpy(0.5 * rng.normal(size=(batch, hidden)).astype(np.float32)).to(dev)
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
                cudnn, x_l = cudnn_in(cudnn, dtype), x.to(dtype)
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
    cudnn = torch.nn.LSTM(w_ih.shape[0], w_hh.shape[0], batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_ih.t())
        cudnn.weight_hh_l0.copy_(w_hh.t())
        cudnn.bias_ih_l0.copy_(b_ih)
        cudnn.bias_hh_l0.copy_(b_hh)
    return cudnn


def layer_grads(torch, layer, x, weights, seq_len, h0, c0, loss_weights):
    """Gradients of sum(y*wy) + sum(hn*wh) + sum(cn*wc) with respect to x,
    the four weights, h0 and c0 (zeros given when there is no state)."""
    batch, hidden = x.shape[0], weights[1].shape[0]
    h0 = torch.zeros((batch, hidden), device=x.device) if h0 is None else h0
    c0 = torch.zeros((batch, hidden), device=x.device) if c0 is None else c0
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
        cudnn = cudnn_in(cudnn_layer(torch, dev, *weights), dtype)
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
    the middle one, which is block 0 in a grid of one), each phase's median
    us a step over steps SPLIT_SKIP.. and the mean step; cycles become us by
    the launch's clock64 and globaltimer deltas."""
    rec = split.cpu().double().view(2, -1)
    n = len(SPLIT_PHASES)
    blocks = {}
    for slot, name in enumerate(('block_0', 'block_middle')):
        cycles = rec[slot, :steps * n].view(steps, n)[SPLIT_SKIP:]
        c_start, ns_start, c_end, ns_end = rec[slot, steps * n:].tolist()
        if c_end == c_start:   # a grid of one block writes one record
            continue
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
    block 0 and the middle block; then k1c_step_split (B16, and B32 with the
    gate trace) and k2c_step_split (B32) of the bf16 cluster kernels, CTA 0
    and the middle CTA of the grid, with the launch's plan (n8 tiles a
    cluster, clusters, clusters that fit at once)."""
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.ops import precision

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

    # K1c and K2c's cluster kernels (bf16 products, f32 storage): K1c at B16
    # (serving) and with its gate trace at B32, K2c on that trace. Their
    # phases: exchange (the DSMEM hand-over), product, reduction (K2c: the
    # sum of the CTAs' partials; none in K1c), gates, barrier (arrive to
    # wait, with the trace stores and the next inputs' issue between).
    for batch, gates in ((SERVE_BATCH, False), (TRAIN_BATCH, True)):
        x, (w_ih, w_hh, b_ih, b_hh), _, _, _ = layer_inputs(torch, dev, batch, steps, False, 72)
        xg = (precision.matmul(x, w_ih, torch.bfloat16) + (b_ih + b_hh)).transpose(0, 1) \
            .contiguous()
        zeros = torch.zeros((batch, H), device=dev)
        for _ in range(2):
            split.zero_()
            out = lstm_ops._lstm_fwd_cuda(xg, w_hh, zeros, zeros, with_gates=gates, split=split,
                                          compute_bf16=True)
            torch.cuda.synchronize()
        emit({'phase': 'k1c_step_split', 'route': 'cluster', 'source': 'lstm_fwd_bf16.cu',
              'B': batch, 'T': steps, 'H': H, 'gates': gates,
              'plan_tiles_clusters_fit': lstm_ops.cluster_plan(batch, H, gates),
              'steps_recorded': SPLIT_STEPS, 'skipped': SPLIT_SKIP,
              **read_split(torch, split, SPLIT_STEPS)})
    _, c_all, g_all, _, _ = out
    for _ in range(2):
        split.zero_()
        lstm_ops._lstm_bwd_cuda(g_all, w_hh, zeros, c_all, *cot, split=split, compute_bf16=True)
        torch.cuda.synchronize()
    emit({'phase': 'k2c_step_split', 'route': 'cluster', 'source': 'lstm_bwd_bf16.cu',
          'B': TRAIN_BATCH, 'T': steps, 'H': H,
          'plan_tiles_clusters_fit': lstm_ops.cluster_plan(TRAIN_BATCH, H, backward=True),
          'steps_recorded': SPLIT_STEPS, 'skipped': SPLIT_SKIP,
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


def cudnn_in(module, dtype):
    """A cuDNN RNN `module` cast to `dtype` with its weights flattened into
    one buffer again (after a cast cuDNN would copy them at every call)."""
    module = module.to(dtype)
    module.flatten_parameters()
    return module


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


def gru_bf16_step_split_phase(torch, dev, seed=43):
    """Where K3c's and K4c's step goes (csrc/gru_fwd_bf16.cu,
    csrc/gru_bwd_bf16.cu): at F0Model's H64 (T1024; K3c at B16 and B32,
    K4c at B32) and DurationModel's H128 (B32 T128), the us a step of the
    whole launch by CUDA events, in turns with the f32 K3's or K4's at the
    same shape (bf16, f32, f32, bf16); then the step_split build's records
    (CTA 0 and the middle CTA, the median of the steps recorded after the
    first SPLIT_SKIP: product; gates, which in K3c include staging bf16(h)
    and storing y; 'exchange', K4c's prefetch; barrier). The clock marks
    order only each other, so work the compiler schedules across a mark
    counts in the next phase, and work between a step's barrier and the
    next step's first mark in none: mean_step_us can fall short of
    us_per_step. The step_split build's outputs within BF16_ULPS bf16 ulps
    of the largest |value| of the main path's."""
    from morgana_tpu_torch.ops import gru as gru_ops

    rng = np.random.default_rng(seed)
    for kernel, hidden, batch, steps in (('k3c', 64, SERVE_BATCH, 1024),
                                         ('k3c', 64, TRAIN_BATCH, 1024),
                                         ('k3c', 128, TRAIN_BATCH, 128),
                                         ('k4c', 64, TRAIN_BATCH, 1024),
                                         ('k4c', 128, TRAIN_BATCH, 128)):
        x, (w_ih, w_hh, b_ih, b_hh), _, _ = gru_inputs(torch, dev, batch, steps, hidden,
                                                       hidden, False, seed)
        xg = torch.matmul(x, w_ih) + b_ih
        hs = torch.zeros((batch, hidden), device=dev)
        y, _ = gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, hs, compute_bf16=True)
        _, hg = gru_ops.hidden_gates(w_hh, b_hh, hs, y, batch_first=True,
                                     compute=torch.bfloat16)
        dy = torch.from_numpy(rng.normal(size=(batch, steps, hidden)).astype(np.float32)).to(dev)
        bwd = (xg, hg, w_hh, hs, y, dy, hs)
        if kernel == 'k3c':
            bf16 = lambda **k: gru_ops._gru_fwd_cuda(  # noqa: E731,B023
                xg, w_hh, b_hh, hs, compute_bf16=True, **k)
            f32 = lambda: gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, hs)  # noqa: E731,B023
        else:
            bf16 = lambda **k: gru_ops._gru_bwd_cuda(*bwd, compute_bf16=True, **k)  # noqa: E731,B023
            f32 = lambda: gru_ops._gru_bwd_cuda(*bwd)  # noqa: E731,B023
        with torch.inference_mode():
            times = {'bf16': [], 'f32': []}
            for key, fn in (('bf16', bf16), ('f32', f32), ('f32', f32), ('bf16', bf16)):
                times[key].append(cuda_ms(torch, fn, 20) * 1e3 / steps)
            want = bf16()
            recorded = min(SPLIT_STEPS, steps)
            split = torch.zeros(2 * (recorded * len(SPLIT_PHASES) + 4), dtype=torch.int64,
                                device=dev)
            for _ in range(2):   # the first launch builds and warms up
                split.zero_()
                got = bf16(split=split)
                torch.cuda.synchronize()
        err = max(max_abs(a - b) / max(max_abs(b), 1e-30) for a, b in zip(got, want))
        emit({'phase': f'{kernel}_step_split', 'H': hidden, 'B': batch, 'T': steps,
              'order': 'bf16, f32, f32, bf16', 'us_per_step': times['bf16'],
              'f32_us_per_step': times['f32'], 'split_build_err_vs_main': err,
              'steps_recorded': recorded, 'skipped': SPLIT_SKIP,
              **read_split(torch, split, recorded)})
        if not err <= BF16_ULPS * 2.0 ** -7:
            raise AssertionError(f'{kernel} step split: the step_split build disagrees with '
                                 f'the main path ({err})')


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


def attention_rows(seq_len, time_steps):
    """The query (and key) rows below seq_len over the batch, of one head:
    the rows of q, k and v (and of do, o and lse backward) that the function
    reads; the kernels load no row of a tile at or past len."""
    return sum(min(max(int(n), 0), time_steps) for n in seq_len)


def attention_bound(batch, heads, time_steps, head_dim, pairs, rows, backward=False):
    """Least time for attention on the route the kernels take, the tensor
    cores in 3xTF32: 3 * 4 * P * dh flops forward (q.k and p.v) and 3 * 10 *
    P * dh backward (q.k and do.v again, then dv, dq and dk: the least work;
    the two-pass kernels recompute both logits products, 14 * P * dh) at the
    TF32 peak; P exp forward and 2 * P backward at the SFU rate; q, k, v read
    on the `rows` rows below seq_len and o, lse written on every row
    (backward: q, k, v, o, do, lse read below seq_len and dq, dk, dv written)
    at the memory rate. Returns (bound_ms, bound_by, simt_bound_ms):
    the largest of the three, what sets it, and the bound the kernels' f32
    CUDA-core versions were held to (the flops once at the f32 peak, or the
    bytes)."""
    width = heads * head_dim
    flops = (10.0 if backward else 4.0) * pairs * head_dim
    if backward:
        nbytes = 4.0 * (5 * rows * width + heads * rows + 3 * batch * time_steps * width)
    else:
        nbytes = 4.0 * (3 * rows * width + batch * time_steps * width + batch * heads * time_steps)
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
                batch, heads, time_steps, head_dim, pairs,
                attention_rows(seq_len.tolist(), time_steps))
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
            batch, heads, time_steps, head_dim, pairs,
            attention_rows(seq_len.tolist(), time_steps), backward=True)
    emit(out)
    if not (max(grad_rel.values()) <= GRAD_RTOL and bwd_rel <= GRAD_RTOL and launched == (1, 1)):
        raise AssertionError(f'K5/K6 gradients disagree: {out}')
    return out


# The parent tree's C entries: name -> (entry, argument types), as the tree
# before K5b's forward redesign has them: K5b the bf16 build of attn_fwd.cu
# (a bf16 flag after causal and window), K5b's backward a source of its own
# with do's planes in a scratch, the carry a scratch, MLPG's solve with a
# scratch of morgana_mlpg_scratch_bytes, K1c and K2c's grid builds
# lstm_fwd.cu and lstm_bwd.cu (storage and compute flags, K2's scratch of
# partials), and K3c and K4c in gru_fwd_bf16.cu and gru_bwd_bf16.cu.
PARENT_ENTRIES = {
    'lstm_fwd': ('morgana_lstm_fwd', ['p'] * 9 + ['i'] * 6 + ['p']),
    'lstm_bwd': ('morgana_lstm_bwd', ['p'] * 12 + ['i'] * 6 + ['p']),
    'attn_fwd': ('morgana_attn_fwd', ['p'] * 6 + ['i'] * 8 + ['p']),
    'attn_bwd': ('morgana_attn_bwd', ['p'] * 11 + ['i'] * 7 + ['p']),
    'attn_bwd_bf16': ('morgana_attn_bwd_bf16', ['p'] * 11 + ['i'] * 7 + ['p']),
    'rnn_dw_bf16': ('morgana_rnn_dw_bf16', ['p'] * 4 + ['i'] * 4 + ['q'] * 4 + ['i', 'p']),
    'mlpg': ('morgana_mlpg_solve', ['p'] * 4 + ['i'] * 4 + ['p']),
    'gru_fwd_bf16': ('morgana_gru_fwd_bf16', ['p'] * 7 + ['i'] * 4 + ['p']),
    'gru_bwd_bf16': ('morgana_gru_bwd_bf16', ['p'] * 11 + ['i'] * 4 + ['p'])}


def build_parent_kernels(parent):
    """The kernels of another tree (`parent` holds its morgana_tpu_torch/csrc,
    e.g. a git archive of the parent commit) named in PARENT_ENTRIES, built
    with this tree's nvcc flags into `parent`/build, one nvcc each, all
    started together. Returns {name: C function} and the compiler's
    register and spill lines."""
    import ctypes

    from morgana_tpu_torch import _build

    kinds = {'p': ctypes.c_void_p, 'i': ctypes.c_int, 'q': ctypes.c_longlong}
    csrc = os.path.join(parent, 'morgana_tpu_torch', 'csrc')
    out_dir = os.path.join(parent, 'build')
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in PARENT_ENTRIES:
        target = os.path.join(out_dir, f'{name}.so')
        procs[name] = target, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', target, os.path.join(csrc, f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for name, (target, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'parent {name}: nvcc exited {proc.returncode}\n{log}')
        logs[name] = [line.strip() for line in log.splitlines() if 'Used' in line or 'spill' in line]
        entry, types = PARENT_ENTRIES[name]
        lib = ctypes.CDLL(target)
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = [kinds[k] for k in types], ctypes.c_int
        fns[name] = fn
        if name == 'rnn_dw_bf16':
            fns['rnn_dw_bf16_scratch'] = lib.morgana_rnn_dw_bf16_scratch
            fns['rnn_dw_bf16_scratch'].argtypes = [ctypes.c_int] * 4
            fns['rnn_dw_bf16_scratch'].restype = ctypes.c_longlong
        if name == 'mlpg':
            fns['mlpg_scratch'] = lib.morgana_mlpg_scratch_bytes
            fns['mlpg_scratch'].argtypes = [ctypes.c_int] * 3
            fns['mlpg_scratch'].restype = ctypes.c_longlong
    return fns, logs


def parent_wrappers(torch, fns, bf16_flag=True):
    """The parent's attention forward (f32, or K5b for bf16 q, k, v), its
    backward (f32, or K5b's), its carry, MLPG's solve, its K1c and K2c at
    H512 (the bf16 builds of lstm_fwd.cu and lstm_bwd.cu) and its K3c and
    K4c, called as this tree's wrappers are: (attention_forward's (o, lse),
    attention_backward's (dq, dk, dv), the carry's dW, mlpg_solve's x, [y,
    c_all, hn, cn] (and g_all with gates), [dxg, dh0, dc0], [y, hn], [dxg,
    dnr, dh0]). Without `bf16_flag` the forward's entry takes no bf16 flag
    (this tree's K5b, morgana_attn_fwd_bf16)."""

    def launch(name, *args):
        err = fns[name](*args, torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'parent {name}: cudaError {err}')

    def lengths(seq_len, batch):
        return torch.as_tensor(seq_len).reshape(batch).to(torch.int32).contiguous()

    def forward(q, k, v, seq_len, causal, window):
        batch, heads, time_steps, head_dim = q.shape
        o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        lens = lengths(seq_len, batch)
        launch('attn_fwd', q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
               o.data_ptr(), lse.data_ptr(), batch, heads, time_steps, head_dim, int(causal),
               int(window or 0), *([int(q.dtype == torch.bfloat16)] if bf16_flag else []))
        return o, lse

    def backward(q, k, v, o, lse, do, seq_len, causal, window):
        batch, heads, time_steps, head_dim = q.shape
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        lens = lengths(seq_len, batch)
        if q.dtype == torch.bfloat16:
            planes = torch.empty((3, *q.shape), dtype=torch.bfloat16, device=q.device)
            inputs, name = (q, k, v, do, lse, lens, delta, planes), 'attn_bwd_bf16'
        else:
            inputs, name = (q, k, v, o, do, lse, lens, delta), 'attn_bwd'
        launch(name, *(t.data_ptr() for t in (*inputs, *grads)), batch, heads, time_steps,
               head_dim, int(causal), int(window or 0))
        return grads

    def carry(h_prev, dg):
        time_steps, batch, hidden = h_prev.shape
        dw = torch.empty((hidden, dg.shape[2]), dtype=torch.float32, device=h_prev.device)
        size = fns['rnn_dw_bf16_scratch'](time_steps, hidden, dg.shape[2],
                                          torch.cuda.current_device())
        scratch = torch.empty(size, dtype=torch.bfloat16, device=h_prev.device) if size else None
        launch('rnn_dw_bf16', h_prev.data_ptr(), dg.data_ptr(), dw.data_ptr(),
               None if scratch is None else scratch.data_ptr(), time_steps, batch, hidden,
               dg.shape[2], h_prev.stride(0), h_prev.stride(1), dg.stride(0), dg.stride(1))
        return dw

    def solve(b, bands):
        frames, lanes, bandwidth = b.shape[0], b.shape[1], bands.shape[0] - 1
        x = torch.empty_like(b)
        scratch = torch.empty(fns['mlpg_scratch'](frames, lanes, bandwidth), dtype=torch.uint8,
                              device=b.device)
        launch('mlpg', b.data_ptr(), bands.data_ptr(), scratch.data_ptr(), x.data_ptr(), frames,
               lanes, bandwidth)
        return x

    def lstm_fwd(xg, w_hh, h0, c0, gates):
        time_steps, batch, gates4 = xg.shape
        y = torch.empty((time_steps, batch, gates4 // 4), device=xg.device)
        c_all, g_all = torch.empty_like(y), torch.empty_like(xg) if gates else None
        hn, cn = torch.empty_like(h0), torch.empty_like(c0)
        launch('lstm_fwd', xg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
               y.data_ptr(), c_all.data_ptr(), None if g_all is None else g_all.data_ptr(),
               hn.data_ptr(), cn.data_ptr(), time_steps, batch, gates4 // 4, 0, 1)
        return [y, c_all, hn, cn] + ([g_all] if gates else [])

    def lstm_bwd(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn):
        time_steps, batch, gates4 = g_all.shape
        hidden = gates4 // 4
        dxg, dh0, dc0 = torch.empty_like(g_all), torch.empty_like(dhn), torch.empty_like(dcn)
        part = torch.empty(2 * 64 * batch * hidden, device=g_all.device)
        launch('lstm_bwd', *(t.data_ptr() for t in (g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn,
                                                     dxg, dh0, dc0, part)),
               time_steps, batch, hidden, 0, 1)
        return [dxg, dh0, dc0]

    def gru_fwd(xg, w_hh, b_hh, h0, seq_len=None):
        batch, time_steps, gates3 = xg.shape
        y = torch.empty((batch, time_steps, gates3 // 3), device=xg.device)
        hn = torch.empty_like(h0)
        launch('gru_fwd_bf16', xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
               None if seq_len is None else seq_len.data_ptr(), y.data_ptr(), hn.data_ptr(),
               time_steps, batch, gates3 // 3)
        return [y, hn]

    def gru_bwd(xg, hg, w_hh, h0, y, dy, dhn, seq_len=None):
        batch, time_steps, gates3 = xg.shape
        dxg, dnr, dh0 = torch.empty_like(xg), torch.empty_like(y), torch.empty_like(dhn)
        launch('gru_bwd_bf16', *(t.data_ptr() for t in (xg, hg, w_hh, h0, y, dy, dhn)),
               None if seq_len is None else seq_len.data_ptr(),
               *(t.data_ptr() for t in (dxg, dnr, dh0)), time_steps, batch, gates3 // 3)
        return [dxg, dnr, dh0]

    return forward, backward, carry, solve, lstm_fwd, lstm_bwd, gru_fwd, gru_bwd


# The carry's shapes in the parent comparison: (name, T, B, H, G,
# batch_major) of the LSTM (B32 T1024), F0Model and DurationModel layers.
CARRY_PARENT_SHAPES = (('lstm', 1024, TRAIN_BATCH, H, 4 * H, False),
                       ('f0', 1024, TRAIN_BATCH, 64, 192, True),
                       ('duration', 128, TRAIN_BATCH, 128, 384, True))


def kernel_parent_phase(torch, dev, parent):
    """The parent tree's attention kernels, carry and bf16 LSTM kernels
    beside this tree's in one process, in turns (parent, this, this,
    parent), on the same inputs:
    the f32 forward and K5b (the forward on bf16 q, k, v) at B16 (the
    serving batch, full) and B32 (full, causal and causal with window 256),
    the f32 backward and K5b's backward at B32 (the training batch), T1024
    H4 dh96, and the carry at CARRY_PARENT_SHAPES. The f32
    outputs are held to each other as k5 / k5_bwd hold them to the plain
    version (KERNEL_TOL abs, GRAD_RTOL of the largest |value|), the bf16
    ones within BF16_ULPS bf16 ulps of the largest |value| (of o on the rows
    below seq_len, of the three gradients, or of dW). Beside K5b and its
    backward, SDPA's forward (and forward+backward) on the same bf16 q, k,
    v, and K5b's device ms in turns by the profiler (its events' time holds
    the wrapper's host time at these sizes), with SDPA's forward by the
    profiler too; beside the carry, the f32 dW
    GEMM it replaces.
    Then MLPG's solve alone and the whole mlpg() against the parent's solve
    and route at mlpg_case's inputs, within MLPG_RTOL of the largest |x|
    (the parent's solve gives the plain loop's bits); then K1c at B16 and
    K1c with its gate trace and K2c at B32, T1024 H512 (this tree's cluster
    kernels, the parent's grid builds), within BF16_ULPS bf16 ulps of the
    largest |value| of their outputs; then K3c (H64 B16 and B32 T1024, H128
    B32 T128) and K4c (H64 B32 T1024, H128 B32 T128) against the parent's,
    likewise; then the bf16 Transformer's serving batch and train step with
    the parent's K5b in place of this tree's
    (transformer_bf16_parent_turns). Every row is measured;
    the phase fails after its line if any row disagreed."""
    from morgana_tpu_torch.ops import flash_attention as fa
    from morgana_tpu_torch.ops import mlpg as mlpg_ops
    from morgana_tpu_torch.ops import weight_grad
    from morgana_tpu_torch.ops._kernels import load_library

    fns, ptxas = build_parent_kernels(parent)
    (parent_fwd, parent_bwd, parent_carry, parent_solve, parent_lstm_fwd, parent_lstm_bwd,
     parent_gru_fwd, parent_gru_bwd) = parent_wrappers(torch, fns)
    # This tree's K5b through the same bare call as the parent's.
    this_fwd_bf16 = parent_wrappers(torch, {'attn_fwd': load_library(
        'attn_fwd_bf16', 'morgana_attn_fwd_bf16', fa.FWD_BF16_ARGTYPES)[1]}, bf16_flag=False)[0]
    # (kernel, B, causal, window, seed): the inputs of main()'s timed k5,
    # k5b, k5_bwd and k5b_bwd cases at dh 96.
    masks = ((False, None), (True, None), (True, 256))
    cases = ([('attn_fwd', SERVE_BATCH, False, None, 51)]
             + [('attn_fwd', TRAIN_BATCH, c, w, 52) for c, w in masks]
             + [('attn_fwd_bf16', SERVE_BATCH, False, None, 107)]
             + [('attn_fwd_bf16', TRAIN_BATCH, c, w, 110) for c, w in masks]
             + [('attn_bwd', TRAIN_BATCH, c, w, seed) for (c, w), seed in zip(masks, (56, 57, 58))]
             + [('attn_bwd_bf16', TRAIN_BATCH, c, w, seed)
                for (c, w), seed in zip(masks, (116, 117, 117))])
    rows, disagree = [], []

    def compare(row, this, parent_fn, reps, tol_of, kernels=None):
        """`kernels`: the names of this tree's and the parent's kernels, whose
        device ms the profiler takes in the same turns."""
        times, outs = {'parent': [], 'this': []}, {}
        device = {'parent': [], 'this': []}
        for who in ('parent', 'this', 'this', 'parent'):
            fn = this if who == 'this' else parent_fn
            times[who].append(cuda_ms(torch, fn, reps))
            if kernels:
                device[who].append(kernel_device_ms(torch, fn, reps,
                                                    kernels[who == 'parent'])[0])
            outs[who] = fn()
        torch.cuda.synchronize()
        err, tol = tol_of(outs['this'], outs['parent'])
        row.update(parent_ms=times['parent'], ms=times['this'],
                   speedup=min(times['parent']) / max(times['this']), err_vs_parent=err,
                   tolerance=tol)
        if kernels:
            row.update(parent_device_ms=device['parent'], device_ms=device['this'],
                       device_speedup=min(device['parent']) / max(device['this']))
        rows.append(row)
        if not err <= tol:
            disagree.append(row)

    def grads_rel(got, want):
        scale = max(max(max_abs(w.float()) for w in want), 1e-30)
        return max(max_abs(a.float() - b.float()) for a, b in zip(got, want)) / scale

    for kernel, batch, causal, window, seed in cases:
        q, k, v, seq_len = attention_inputs(torch, dev, batch, 4, 1024, 96, seed)
        mask = dict(seq_len=seq_len, causal=causal, window=window)
        pairs = attention_pairs(seq_len.tolist(), 1024, 4, causal, window)
        rows_below = attention_rows(seq_len.tolist(), 1024)
        row = {'kernel': kernel, 'B': batch, 'causal': causal, 'window': window,
               'visible_pairs': pairs}
        if kernel == 'attn_fwd':
            row['bound_ms'], row['bound_by'], row['simt_bound_ms'] = attention_bound(
                batch, 4, 1024, 96, pairs, rows_below)
            valid = valid_rows(torch, seq_len, 1024)
            compare(row, lambda: fa.attention_forward(q, k, v, **mask)[0],
                    lambda: parent_fwd(q, k, v, **mask)[0], 20,
                    lambda a, b: (max_abs((a - b) * valid), KERNEL_TOL))
            continue
        if kernel == 'attn_fwd_bf16':
            # Both trees' K5b by the same bare ctypes call (parent_wrappers'
            # forward): at these sizes the events' time is the host's, and
            # fa.attention_forward's checks cost more of it than the bare
            # call; the profiler's device ms are the kernels' own.
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            row['bound_ms'], row['bound_by'] = attention_bf16_bound(batch, 4, 1024, 96, pairs,
                                                                  rows_below)
            row['library_ms'] = cuda_ms(torch, lambda: sdpa(torch, qb, kb, vb, **mask), 20)
            row['library_device_ms'] = call_device_ms(
                torch, lambda: sdpa(torch, qb, kb, vb, **mask), 20)
            row['wrapper_ms'] = cuda_ms(torch, lambda: fa.attention_forward(qb, kb, vb, **mask), 20)
            valid = valid_rows(torch, seq_len, 1024)
            compare(row, lambda: this_fwd_bf16(qb, kb, vb, **mask)[0],
                    lambda: parent_fwd(qb, kb, vb, **mask)[0], 20,
                    lambda a, b: (max_abs((a - b) * valid) / max(max_abs(b * valid), 1e-30),
                                  BF16_ULPS * 2.0 ** -7),
                    kernels=('attn_fwd_bf16_kernel', 'attn_fwd_kernel'))
            continue
        rng = np.random.default_rng(seed + 100)
        weight = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(dev)
        weight = weight * valid_rows(torch, seq_len, 1024)
        if kernel == 'attn_bwd_bf16':
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            row['bound_ms'], row['bound_by'], _ = attention_bf16_bwd_bound(batch, 4, 1024, 96,
                                                                           pairs, rows_below)
            tol = BF16_ULPS * 2.0 ** -7

            def sdpa_grads():
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                out = sdpa(torch, *leaves, **mask)
                return torch.autograd.grad((out.float() * weight).sum(), leaves)

            row['library_ms'] = cuda_ms(torch, sdpa_grads, 10)
        else:
            row['bound_ms'], row['bound_by'], row['simt_bound_ms'] = attention_bound(
                batch, 4, 1024, 96, pairs, rows_below, backward=True)
            tol = GRAD_RTOL
        o, lse = fa.attention_forward(q, k, v, **mask)
        compare(row, lambda: fa.attention_backward(q, k, v, o, lse, weight, **mask),
                lambda: parent_bwd(q, k, v, o, lse, weight, **mask), 10,
                lambda a, b: (grads_rel(a, b), tol))

    for name, time_steps, batch, hidden, gates, batch_major in CARRY_PARENT_SHAPES:
        rng = np.random.default_rng(131)

        def tensor(*shape):
            t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
            return t.transpose(0, 1).contiguous().transpose(0, 1) if batch_major else t

        h_prev, dg = tensor(time_steps, batch, hidden), 1e-2 * tensor(time_steps, batch, gates)
        row = {'kernel': 'rnn_dw_bf16', 'model': name, 'T': time_steps, 'B': batch, 'H': hidden,
               'G': gates, 'batch_major': batch_major,
               'f32_gemm_ms': cuda_ms(torch, lambda: torch.einsum('tbh,tbg->hg', h_prev, dg), 10)}
        row['bound_ms'], row['bound_by'] = carry_bound(batch, time_steps, hidden, gates)
        compare(row, lambda: weight_grad.bf16_weight_grad(h_prev, dg),
                lambda: parent_carry(h_prev, dg), 5,
                lambda a, b: (grads_rel([a], [b]), BF16_ULPS * 2.0 ** -7))

    # MLPG at mlpg_case's inputs: the solve alone against the parent's on the
    # same systems (its bits are the plain loop's), then the whole of mlpg()
    # against the parent's route (banded_system, its solve, the unpad). The
    # times are ms a call, launches included (CUDA events); device_ms is the
    # kernel's alone (the profiler).
    for label, feats, seed in (('lstm', MLPG_FEATS['lstm'], 71), ('f0', MLPG_FEATS['f0'], 72)):
        rng = np.random.default_rng(seed)
        means = torch.from_numpy(rng.normal(size=(SERVE_BATCH, 1024, 3 * feats))
                                 .astype(np.float32)).to(dev)
        variances = torch.from_numpy(rng.uniform(0.2, 2.0, size=(3 * feats,))
                                     .astype(np.float32)).to(dev)
        seq_len = rng.integers(200, 1025, SERVE_BATCH)
        seq_len[0] = 1024
        seq_len = torch.from_numpy(seq_len).to(dev)
        b, bands, _ = mlpg_ops.banded_system(means, variances, padding_size=MLPG_PADDING,
                                             seq_len=seq_len)

        def rel(got, want):
            return max_abs(got - want) / max(max_abs(want), 1e-30), MLPG_RTOL

        row = {'kernel': 'mlpg_solve', 'case': label, 'T_padded': int(b.shape[0]),
               'lanes': int(b.shape[1]),
               'device_ms': kernel_device_ms(torch, lambda: torch.ops.morgana.mlpg_solve(
                   b, bands), 20, 'mlpg_kernel')[0],
               'parent_device_ms': kernel_device_ms(torch, lambda: parent_solve(b, bands), 20,
                                                    'mlpg_solve_kernel')[0]}
        compare(row, lambda: torch.ops.morgana.mlpg_solve(b, bands),
                lambda: parent_solve(b, bands), 20, rel)

        def parent_mlpg():
            sys_b, sys_bands, lens = mlpg_ops.banded_system(
                means, variances, padding_size=MLPG_PADDING, seq_len=seq_len)
            traj = parent_solve(sys_b, sys_bands)
            traj = traj.reshape(-1, SERVE_BATCH, feats).permute(1, 0, 2)
            traj = traj[:, MLPG_PADDING:MLPG_PADDING + 1024]
            mask = torch.arange(1024, device=dev)[None, :] < lens[:, None]
            return torch.where(mask[:, :, None], traj, 0.)

        compare({'kernel': 'mlpg', 'case': label},
                lambda: mlpg_ops.mlpg(means, variances, padding_size=MLPG_PADDING,
                                      seq_len=seq_len), parent_mlpg, 20, rel)
    # K1c (B16, the serving batch), K1c with its gate trace and K2c (B32,
    # the training batch) at T1024 H512: this tree's cluster kernels against
    # the parent's grid builds, within BF16_ULPS bf16 ulps of the largest
    # |value| of their outputs.
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.ops import precision

    for kernel, batch, seed in (('lstm_fwd_bf16', SERVE_BATCH, 101),
                                ('lstm_fwd_bf16_gates', TRAIN_BATCH, 111),
                                ('lstm_bwd_bf16', TRAIN_BATCH, 111)):
        x, (w_ih, w_hh, b_ih, b_hh), _, _, _ = layer_inputs(torch, dev, batch, 1024, False, seed)
        xg = (precision.matmul(x, w_ih, torch.bfloat16) + (b_ih + b_hh)).transpose(0, 1) \
            .contiguous()
        zeros = torch.zeros((batch, H), device=dev)
        gates = kernel != 'lstm_fwd_bf16'
        row = {'kernel': kernel, 'B': batch, 'T': 1024, 'H': H}
        if kernel == 'lstm_bwd_bf16':
            _, c_all, g_all, _, _ = lstm_ops.lstm_recurrence(xg, w_hh, zeros, zeros, True, True)
            rng = np.random.default_rng(seed + 200)
            cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                   for shape in ((1024, batch, H),) * 2 + ((batch, H),) * 2]
            args = (g_all, w_hh, zeros, c_all, *cot)
            row['bound_ms'], row['bound_by'] = k2_bound(batch, 1024, H, compute='bfloat16')
            this = lambda: list(lstm_ops.lstm_backward(*args, compute_bf16=True))  # noqa: E731,B023
            other = lambda: parent_lstm_bwd(*args)  # noqa: E731,B023
        else:
            row['bound_ms'], row['bound_by'] = k1_bound(batch, 1024, H, gates, compute='bfloat16')

            def this(gates=gates, xg=xg, zeros=zeros):
                y, c_all, g_all, hn, cn = lstm_ops.lstm_recurrence(xg, w_hh, zeros, zeros, gates,
                                                                   True)
                return [y, c_all, hn, cn] + ([g_all] if gates else [])

            other = lambda: parent_lstm_fwd(xg, w_hh, zeros, zeros, gates)  # noqa: E731,B023
        compare(row, this, other, 10,
                lambda a, b: (grads_rel(a, b), BF16_ULPS * 2.0 ** -7))

    # K3c at F0Model's H64 (B16 serving, B32 training, T1024) and
    # DurationModel's H128 (B32 T128), K4c at the training shapes: this
    # tree's csrc/gru_fwd_bf16.cu and csrc/gru_bwd_bf16.cu against the
    # parent's, batch-major, no seq_len, within BF16_ULPS bf16 ulps of the
    # largest |value|.
    from morgana_tpu_torch.ops import gru as gru_ops

    for kernel, hidden, batch, steps, seed in (('gru_fwd_bf16', 64, SERVE_BATCH, 1024, 104),
                                               ('gru_fwd_bf16', 64, TRAIN_BATCH, 1024, 113),
                                               ('gru_fwd_bf16', 128, TRAIN_BATCH, 128, 114),
                                               ('gru_bwd_bf16', 64, TRAIN_BATCH, 1024, 113),
                                               ('gru_bwd_bf16', 128, TRAIN_BATCH, 128, 114)):
        x, (w_ih, w_hh, b_ih, b_hh), _, _ = gru_inputs(torch, dev, batch, steps, hidden, hidden,
                                                       False, seed)
        xg = precision.matmul(x, w_ih, torch.bfloat16) + b_ih
        hs = torch.zeros((batch, hidden), device=dev)
        row = {'kernel': kernel, 'B': batch, 'T': steps, 'H': hidden}
        if kernel == 'gru_fwd_bf16':
            row['bound_ms'], row['bound_by'] = k3_bound(batch, steps, hidden, 'bfloat16')
            this = lambda: list(gru_ops._gru_fwd_cuda(  # noqa: E731,B023
                xg, w_hh, b_hh, hs, compute_bf16=True))
            other = lambda: parent_gru_fwd(xg, w_hh, b_hh, hs)  # noqa: E731,B023
        else:
            y, _ = gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, hs, compute_bf16=True)
            _, hg = gru_ops.hidden_gates(w_hh, b_hh, hs, y, batch_first=True,
                                         compute=torch.bfloat16)
            rng = np.random.default_rng(seed + 200)
            dy, dhn = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                       for shape in ((batch, steps, hidden), (batch, hidden)))
            args = (xg, hg, w_hh, hs, y, dy, dhn)
            row['bound_ms'], row['bound_by'] = k4_bound(batch, steps, hidden, 'bfloat16')
            this = lambda: list(gru_ops._gru_bwd_cuda(  # noqa: E731,B023
                *args, compute_bf16=True))
            other = lambda: parent_gru_bwd(*args)  # noqa: E731,B023
        compare(row, this, other, 20, lambda a, b: (grads_rel(a, b), BF16_ULPS * 2.0 ** -7))

    rows += transformer_bf16_parent_turns(torch, parent_fwd)
    emit({'phase': 'kernel_parent_compare', 'parent': parent, 'parent_ptxas': ptxas,
          'order': 'parent, this, this, parent', 'nvidia_smi': nvidia_smi(), 'rows': rows})
    if disagree:
        raise AssertionError(f'this tree and the parent disagree: {disagree}')
    return rows


def transformer_bf16_parent_turns(torch, parent_fwd, seed=122):
    """TransformerAcousticModel's bf16 main path with this tree's K5b and
    with the parent's (attn_fwd.cu's bf16 build) in its place (the bf16
    launches of attention_forward routed to it; every other kernel the
    same), in turns (parent, this, this, parent): a B16 serving batch of
    make_items through the bf16 engine's predict, and a train step of the
    ExperimentBuilder under --compute_dtype bfloat16 (lr 0.001) on a B32
    batch of the train corpus. For each: the median of 5 synchronised calls
    on the host clock, and one profiled call's device busy ms, idle share
    and attention-forward device ms (K5b; the parent's build traces as the
    f32 forward). The two trees' outputs within BF16_ULPS bf16 ulps of the
    largest |value| (the step's loss, the batch's normalised mcep)."""
    from morgana_tpu_torch import data
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
    from morgana_tpu_torch.ops import flash_attention as fa
    from morgana_tpu_torch.serve import InferenceEngine

    this_fwd = fa.attention_forward
    parent_calls = [0]

    def routed(q, k, v, seq_len=None, causal=False, window=None):
        if q.dtype != torch.bfloat16:
            return this_fwd(q, k, v, seq_len, causal, window)
        parent_calls[0] += 1
        return parent_fwd(q, k, v, seq_len, causal, window)

    def host_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        return float(np.median(times))

    rows = []
    with tempfile.TemporaryDirectory() as root:
        rng = np.random.default_rng(seed)
        ckpt = seeded_checkpoint(torch, TransformerAcousticModel,
                                 os.path.join(root, 'init', 'epoch_0.npz'), seed)
        write_normalisers(root, rng)
        items = make_items(rng)
        engine = InferenceEngine(TransformerAcousticModel, ckpt, data_root=root,
                                 batch_size=SERVE_BATCH, compute_dtype='bfloat16')
        features = data.collate([data.assemble_item(
            engine.model.test_data_sources(), engine.model.normalisers,
            lambda key, source, item=item: source.package(item[key]), item['name'])
            for item in items[:SERVE_BATCH]])
        batch = data.device_features(features, engine.device)

        def serve():
            with compute_dtype('bfloat16'), torch.inference_mode():
                return engine.model.predict(batch)['normalised_mcep_deltas']

        data_root, _ = train_corpus(root)
        args = ExperimentBuilder.get_experiment_args(builder_argv(
            data_root, os.path.join(root, 'experiments'), 'transformer_parent_turns', ckpt,
            '--end_epoch', '1', '--compute_dtype', 'bfloat16', '--learning_rate',
            TRANSFORMER_LR))
        exp = ExperimentBuilder(TransformerAcousticModel, **args)
        train_batch = host_features(next(iter(exp.train_loader)))
        exp.model.mode = 'train'
        initial = {k: v.detach().clone() for k, v in exp.loop.params.items()}

        def train():
            # Each call from the same weights, so that the step's loss compares.
            with torch.no_grad():
                for name, param in exp.loop.params.items():
                    param.copy_(initial[name])
            return exp.loop.train_step(train_batch, exp.learning_rate)[0]

        for label, fn in (('transformer_bf16_serve_batch', serve),
                          ('transformer_bf16_train_step', train)):
            row = {'kernel': label, 'B': SERVE_BATCH if label.endswith('batch') else TRAIN_BATCH,
                   'ms': [], 'parent_ms': [], 'device_busy_ms': [], 'parent_device_busy_ms': [],
                   'idle_share': [], 'parent_idle_share': [], 'attn_fwd_device_ms': [],
                   'parent_attn_fwd_device_ms': []}
            outs = {}
            for who in ('parent', 'this', 'this', 'parent'):
                fa.attention_forward = routed if who == 'parent' else this_fwd
                before = parent_calls[0]
                try:
                    ms = host_ms(fn)
                    prof = profile_step(torch, fn, counted=who == 'this')
                    outs[who] = fn()
                finally:
                    fa.attention_forward = this_fwd
                if (parent_calls[0] > before) != (who == 'parent'):
                    raise AssertionError(f'{label}: the {who} run took the wrong K5b')
                pre = 'parent_' if who == 'parent' else ''
                row[f'{pre}ms'].append(ms)
                row[f'{pre}device_busy_ms'].append(prof['device_busy_ms'])
                row[f'{pre}idle_share'].append(prof['device_idle_share'])
                row[f'{pre}attn_fwd_device_ms'].append(sum(
                    prof[f'{kind}_device_ms'] for kind in ('attn_fwd', 'k5b')
                    if prof[f'{kind}_device_ms'] != 'not measured'))
                if prof['launch_mismatch']:
                    row['launch_mismatch'] = prof['launch_mismatch']
            got, want = (torch.as_tensor(outs[w]).float() for w in ('this', 'parent'))
            row['err_vs_parent'] = max_abs(got - want) / max(max_abs(want), 1e-30)
            row['tolerance'] = BF16_ULPS * 2.0 ** -7
            rows.append(row)
    return rows


def mlpg_flops(bandwidth):
    """Operations of one lane and frame of the solve in the plain loop's
    order: the factorisation's products, differences and divisions, the
    pivot's squares, differences, clamp and root; the forward and back
    substitutions' products, differences and division. (The kernel's
    partitioned substitutions do BW + 1 right-hand sides in float64; the
    bound counts what the solve needs.)"""
    factor = sum(2 * (bandwidth - p) + 1 for p in range(1, bandwidth + 1)) + 2 * bandwidth + 2
    return factor + 2 * (2 * bandwidth + 1)


def mlpg_build_flops(windows):
    """Operations of one lane and frame of the system build: 1 / variance
    and mean / variance a window, a product and a sum a nonzero tap of b and
    of the bands."""
    taps = 0
    for _, _, coeffs in windows:
        taps += sum(1 for c in coeffs if c != 0)
        taps += sum(1 for p in range(len(coeffs)) for a in range(len(coeffs) - p)
                    if coeffs[a] * coeffs[a + p] != 0)
    return 2 * taps + 2 * len(windows)


def mlpg_bound(frames, lanes, bandwidth):
    """Least time for the solve: b and the BW + 1 bands read once and x
    written once at the memory rate, against its operations at the f32
    peak. (The dependence of the steps along time, which the kernel's time
    follows, is not in it.)"""
    bytes_ms = (bandwidth + 3) * frames * lanes * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = mlpg_flops(bandwidth) * frames * lanes / F32_PEAK_FLOPS * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def mlpg_fused_bound(means, variances, out, seq_len, padded_rows, windows):
    """Least time for the whole of MLPG: the means, the variances as passed
    and seq_len read once and the trajectory written once at the memory
    rate, against the build's and the solve's operations over the valid
    rows (``padded_rows``: sum over lanes of seq_len + 2 * padding) at the
    f32 peak."""
    bandwidth = max(l + u for l, u, _ in windows)
    nbytes = 4 * (means.numel() + variances.numel() + out.numel()) + 8 * seq_len.numel()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ((mlpg_flops(bandwidth) + mlpg_build_flops(windows)) * padded_rows
              / F32_PEAK_FLOPS * 1e3)
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def kernel_device_ms(torch, fn, reps, name):
    """Device milliseconds a launch of the kernels whose name holds `name`,
    over `reps` calls of `fn` (the profiler's CUDA activity; the launches'
    host time is not in it), and how many such launches a call made; None
    where the profiler saw no device time in three sessions (on the H100 a
    session has come back empty)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in events)
        if count:
            return sum(e.self_device_time_total for e in events) / 1e3 / count, count / reps
    return None, 0


def call_device_ms(torch, fn, reps):
    """Device milliseconds of one call of `fn`: every kernel, copy and fill
    it puts on the card (the profiler's CUDA activity), each at its mean
    time times its launches a call (rounded, as the profiler may miss a
    session's first record); None where the profiler saw no device time in
    three sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        if events:
            return sum(e.self_device_time_total / e.count * max(1, round(e.count / reps))
                       for e in events) / 1e3
    return None


def device_kernels(torch, fn, reps=10):
    """The device kernels `reps` calls of `fn` launch, by name, as the
    profiler counts them. On the H100 the profiler has missed records at the
    ends of a session's window (a kernel launched once a call has counted
    reps - 1 and reps - 2) and has come back empty: so the counted step
    follows a warm-up step, with an idle margin of host time at each end, as
    in `profile_call`; a session that counted fewer than reps - 1 records in
    all is taken again, up to three in all, and the one that counted the
    most is returned ({} if none saw any)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
        kernels = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, 'is_user_annotation', False)
                    and not e.name.startswith('ProfilerStep')):
                kernels[e.name] = kernels.get(e.name, 0) + 1
        if sum(kernels.values()) > sum(best.values()):
            best = kernels
        if sum(best.values()) >= reps - 1:
            break
    return best


def banded_f64(b, bands, valid):
    """Float64 solutions of the f32 systems (T', lanes) on the host
    (scipy's banded Cholesky), lane by lane over each lane's first
    ``valid`` rows (x = 0 past them)."""
    import scipy.linalg

    bw = bands.shape[0] - 1
    b64, bands64 = b.double().cpu().numpy(), bands.double().cpu().numpy()
    x = np.zeros(b64.shape)
    for lane, n in enumerate(valid):
        if n == 0:
            continue
        upper = np.zeros((bw + 1, n))
        for m in range(min(bw + 1, n)):
            upper[bw - m, m:] = bands64[m, :n - m, lane]
        x[:n, lane] = scipy.linalg.solveh_banded(upper, b64[:n, lane])
    return x


def mlpg_errors(got, plain, exact):
    """The kernel's error against the plain loop (absolute and relative to
    the largest |x|), and its max and mean error against float64 beside the
    plain loop's own (and the loop's own relative to its largest |x|);
    whether it holds to MLPG_RTOL against the loop and to twice the loop's
    float64 errors plus one f32 ulp of the largest |x|."""
    got, plain = got.double().cpu().numpy(), plain.double().cpu().numpy()
    err = float(np.abs(got - plain).max())
    scale = max(float(np.abs(plain).max()), 1e-30)
    rel = err / scale
    ulp = float(np.spacing(np.float32(np.abs(exact).max())))
    mine, own = np.abs(got - exact), np.abs(plain - exact)
    out = {'max_abs_err_vs_plain': err, 'max_rel_err_vs_plain': rel,
           'f64_max_err': float(mine.max()), 'plain_f64_max_err': float(own.max()),
           'f64_mean_err': float(mine.mean()), 'plain_f64_mean_err': float(own.mean()),
           'f32_ulp_of_max': ulp, 'plain_rel_err_vs_f64': float(own.max()) / scale}
    out['within_rtol_of_plain'] = bool(np.isfinite(got).all() and rel <= MLPG_RTOL)
    out['within_f64_bar'] = bool(np.isfinite(got).all() and mine.max() <= 2 * own.max() + ulp
                                 and mine.mean() <= 2 * own.mean() + ulp)
    out['ok'] = out['within_rtol_of_plain'] and out['within_f64_bar']
    return out


def dense_solve_ms(torch, b, bands):
    """One torch.linalg.solve (LU, TF32 off) on the dense (lanes, T', T')
    matrices of the same banded systems: the yardstick a library call gives
    (the port never calls it). Returns its ms and its error against `x`'s
    largest |value| is left to the caller: (ms, x)."""
    bw = bands.shape[0] - 1
    frames, lanes = b.shape
    dense = torch.zeros((lanes, frames, frames), dtype=torch.float32, device=b.device)
    rows = torch.arange(frames, device=b.device)
    dense[:, rows, rows] = bands[0].t()
    for m in range(1, bw + 1):
        dense[:, rows[:-m], rows[m:]] = bands[m, :frames - m].t()
        dense[:, rows[m:], rows[:-m]] = bands[m, :frames - m].t()
    rhs = b.t().unsqueeze(-1).contiguous()
    ms = cuda_ms(torch, lambda: torch.linalg.solve(dense, rhs), 3)
    x = torch.linalg.solve(dense, rhs)[..., 0].t()
    del dense
    torch.cuda.empty_cache()
    return ms, x


def mlpg_case(torch, dev, label, batch, feats, seed):
    """MLPG at B16 T1024 with `feats` static features a window (padding 100,
    ragged seq_len 200-1024, global variances), on the same card inputs:
    the solve alone (morgana::mlpg_solve) on the systems banded_system
    builds, and the whole of MLPG (morgana::mlpg, the build fused into the
    same launch), each against its plain version on the card (the loop; the
    build, the loop and the unpad) within MLPG_RTOL and against a float64
    solve of the same systems within twice the loop's own error plus an
    ulp; one launch each, and mlpg() one device kernel in all (the
    profiler); device ms a launch (the profiler) beside the bound, the
    loop's time, the dense torch.linalg.solve of the same systems and, by
    host clock, the whole mlpg() and the old route (banded_system, then the
    solve). Every number is measured whatever the checks give; the checks
    that failed are under 'failures', which main() raises at its end."""
    from morgana_tpu_torch.ops import mlpg as mlpg_ops

    rng = np.random.default_rng(seed)
    frames = 1024
    windows = mlpg_ops.DEFAULT_WINDOWS
    failures = []
    means = rng.normal(size=(batch, frames, 3 * feats)).astype(np.float32)
    variances = rng.uniform(0.2, 2.0, size=(3 * feats,)).astype(np.float32)
    seq_len = rng.integers(200, frames + 1, batch)
    seq_len[0] = frames
    args = [torch.from_numpy(a).to(dev) for a in (means, variances, seq_len)]
    b, bands, _ = mlpg_ops.banded_system(args[0], args[1], padding_size=MLPG_PADDING,
                                         seq_len=args[2])
    bandwidth = bands.shape[0] - 1
    tp, lanes = b.shape

    # The solve alone, on every row of the built systems.
    before = mlpg_ops.launches
    got = torch.ops.morgana.mlpg_solve(b, bands)
    torch.cuda.synchronize()
    launched = mlpg_ops.launches - before
    want = mlpg_ops._banded_cholesky_solve(b, list(bands.unbind(0)), bandwidth)
    solve = mlpg_errors(got, want, banded_f64(b, bands, [tp] * lanes))
    if launched != 1 or not solve['ok']:
        failures.append(f'mlpg_kernel {label} solve: {launched} launches, {solve}')

    # The whole of MLPG: one launch from the means and variances.
    def run():
        return mlpg_ops.mlpg(*args[:2], padding_size=MLPG_PADDING, seq_len=args[2])

    before, fused_before = mlpg_ops.launches, mlpg_ops.fused_launches
    traj = run()
    torch.cuda.synchronize()
    fused_launched = (mlpg_ops.launches - before, mlpg_ops.fused_launches - fused_before)
    plain_traj = mlpg_ops._mlpg_plain(args[0], args[1].expand(args[0].shape), args[2],
                                      MLPG_PADDING, windows)
    valid = [int(n) + 2 * MLPG_PADDING for n in seq_len for _ in range(feats)]
    exact = banded_f64(b, bands, valid).reshape(tp, batch, feats).transpose(1, 0, 2)
    exact = exact[:, MLPG_PADDING:MLPG_PADDING + frames]
    exact = np.where((np.arange(frames)[None, :] < seq_len[:, None])[:, :, None], exact, 0.)
    fused = mlpg_errors(traj, plain_traj, exact)
    kernels = device_kernels(torch, run, 10)
    if (fused_launched != (1, 1) or not fused['ok'] or not kernels
            or any('mlpg_kernel' not in name for name in kernels)
            or not 9 <= sum(kernels.values()) <= 10):
        failures.append(f'mlpg_kernel {label} mlpg(): launches {fused_launched}, device '
                        f'kernels {kernels}, {fused}')
    cpu = mlpg_ops.mlpg(*(torch.from_numpy(a) for a in (means, variances)),
                        padding_size=MLPG_PADDING, seq_len=torch.from_numpy(seq_len))
    vs_cpu = max_abs(traj.cpu() - cpu) / max(max_abs(cpu), 1e-30)
    if not vs_cpu <= MLPG_RTOL:
        failures.append(f'mlpg_kernel {label}: mlpg() on the card {vs_cpu} from the CPU')

    # Device ms a launch by the profiler (kernel_ms), and ms a call by CUDA
    # events around 20 calls, host launches included (call_ms).
    solve_call_ms = cuda_ms(torch, lambda: torch.ops.morgana.mlpg_solve(b, bands), 20)
    fused_call_ms = cuda_ms(torch, run, 20)
    solve_ms = kernel_device_ms(torch, lambda: torch.ops.morgana.mlpg_solve(b, bands), 20,
                                'mlpg_kernel')[0]
    fused_ms = kernel_device_ms(torch, run, 20, 'mlpg_kernel')[0]
    if solve_ms is None or fused_ms is None:
        raise AssertionError(f'mlpg_kernel {label}: the profiler saw no device time of the '
                             f'MLPG kernel (solve {solve_ms}, mlpg() {fused_ms})')
    plain_ms = cuda_ms(torch, lambda: mlpg_ops._banded_cholesky_solve(
        b, list(bands.unbind(0)), bandwidth), 1, warmup=0)
    plain_mlpg_ms = cuda_ms(torch, lambda: mlpg_ops._mlpg_plain(
        args[0], args[1].expand(args[0].shape), args[2], MLPG_PADDING, windows), 1, warmup=0)
    library_ms, dense_x = dense_solve_ms(torch, b, bands)
    dense_err = max_abs(dense_x - want) / max(max_abs(want), 1e-30)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def old_route():
        sys_b, sys_bands, _ = mlpg_ops.banded_system(args[0], args[1], padding_size=MLPG_PADDING,
                                                     seq_len=args[2])
        return torch.ops.morgana.mlpg_solve(sys_b, sys_bands)

    mlpg_ms = sorted(host_ms(run) for _ in range(7))[3]
    build_ms = sorted(host_ms(lambda: mlpg_ops.banded_system(
        args[0], args[1], padding_size=MLPG_PADDING, seq_len=args[2])) for _ in range(7))[3]
    old_route_ms = sorted(host_ms(old_route) for _ in range(7))[3]
    bound_ms, bound_by = mlpg_bound(tp, lanes, bandwidth)
    fused_bound_ms, fused_bound_by = mlpg_fused_bound(
        args[0], args[1], traj, args[2], sum(valid), windows)
    out = {'case': label, 'B': batch, 'T': frames, 'T_padded': tp, 'lanes': lanes,
           'bandwidth': bandwidth, 'segments_a_lane': 32, 'rtol': MLPG_RTOL,
           'solve': dict(solve, launches=launched, kernel_ms=solve_ms, call_ms=solve_call_ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms, library_rel_err_vs_plain=dense_err,
                         us_per_frame=solve_ms * 1e3 / tp),
           'mlpg': dict(fused, launches=fused_launched[1], device_kernels=kernels,
                        kernel_ms=fused_ms, call_ms=fused_call_ms, plain_ms=plain_mlpg_ms,
                        bound_ms=fused_bound_ms,
                        bound_by=fused_bound_by, vs_cpu_rel_err=vs_cpu),
           'library': 'torch.linalg.solve on the dense (lanes, T\', T\') matrices, TF32 off',
           'mlpg_ms': mlpg_ms, 'system_ms': 0.0, 'build_ms_old_route': build_ms,
           'old_route_ms': old_route_ms, 'mlpg_loop_ms': plain_mlpg_ms, 'failures': failures}
    emit(dict({'phase': 'mlpg_kernel'}, **out))
    return out


def mlpg_timer(torch):
    """A context whose value accumulates the host milliseconds of every
    viz.synthesis.mlpg call made inside it, synchronised around each: the
    one way the serving and training phases time their MLPG (mlpg_ms),
    around one predict or train step after a warm one."""
    from morgana_tpu_torch.viz import synthesis

    @contextlib.contextmanager
    def timer():
        real, spent = synthesis.mlpg, [0.0]

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += (time.perf_counter() - t0) * 1e3
            return out
        synthesis.mlpg = timed
        try:
            yield spent
        finally:
            synthesis.mlpg = real
    return timer()


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
    from morgana_tpu_torch.ops import mlpg as mlpg_ops
    from morgana_tpu_torch.serve import InferenceEngine

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
    solves, fused = mlpg_ops.launches, mlpg_ops.fused_launches
    start = time.perf_counter()
    outputs = engine.predict_items(items)      # returns host arrays: ends synchronised
    seconds = time.perf_counter() - start
    launches = lstm_ops.launches
    bf16_launches = lstm_ops.bf16_launches
    solves, fused = mlpg_ops.launches - solves, mlpg_ops.fused_launches - fused
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
    if launches != 8 * n_batches or bf16_launches != (launches if store else 0) \
            or solves != n_batches or fused != n_batches:
        raise AssertionError(f'K1 launched {launches} times ({bf16_launches} bf16), the MLPG '
                             f'solve {solves}, for {n_batches} batches, expected '
                             f'{8 * n_batches} and {n_batches}')

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
        _, net_ms = timed(lambda: m.layers(inputs, seq_len=batch['n_frames']))
        with mlpg_timer(torch) as mlpg_ms:
            m.predict(batch)
        profile = profile_step(torch, lambda: m.predict(batch))
    emit({'phase': phase, 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
          'rnn_backend': kwargs.get('rnn_backend', 'scan'), 'store': store or 'float32',
          'utterances': N_UTTS, 'frames': frames, 'batch_size': SERVE_BATCH,
          'batches': n_batches, 'seconds': seconds,
          'utterances_per_s': N_UTTS / seconds, 'frames_per_s': frames / seconds,
          'ms_per_batch': seconds / n_batches * 1e3,
          'peak_memory_mib': peak_mib,
          'k1_launches': launches, 'k1_bf16_launches': bf16_launches,
          'k1_launches_expected': 8 * n_batches, 'mlpg_solve_launches': solves,
          'mlpg_launches': fused,
          'gpu_vs_cpu_err': errs, 'net_tol': net_tol, 'traj_rtol': traj_rtol,
          **({'f32_storage_err': control} if store else {})})
    emit(dict({'phase': 'batch_breakdown' + ('_bf16' if store else ''), 'B': SERVE_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'predict_ms': predict_ms, 'inputs_ms': inputs_ms, 'network_ms': net_ms,
               'mlpg_ms': mlpg_ms[0]}, **profile))
    return launches, bf16_launches, {'root': root, 'ckpt': ckpt, 'items': items,
                                     'outputs': outputs}


def seeded_checkpoint(torch, model_class, path, seed, **kwargs):
    """A full-width model (with `kwargs`) with weights from `seed`, saved as
    the JAX package's epoch_0.npz."""
    from morgana_tpu_torch import checkpointing, nn

    model = model_class(generator=torch.Generator().manual_seed(seed), **kwargs)
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


#: The host data path, the CPU's defaults: the phases that hold the card's
#: builder to the CPU's (train_parity, the optimiser and --log_norms cases)
#: or measure the host path (fast_path) pass it; every other phase runs the
#: card's defaults (the device cache and device-side normalisation).
HOST_PATH = ('--no-device_cache', '--no-device_normalise')


def host_features(features):
    """A loader's batch as numpy (``data.host_features``): the phases that
    time or hold steps on a host batch move it to the card in the step, as
    before the loader's prefetch."""
    from morgana_tpu_torch import data

    return data.host_features(features)


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
    from morgana_tpu_torch.ops import mlpg as mlpg_ops

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
    mlpg_before = mlpg_ops.fused_launches
    start = time.perf_counter()
    exp.run_experiment()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    mlpg_launches = mlpg_ops.fused_launches - mlpg_before
    launches = {key: getattr(lstm_ops, name) for key, name in counts.items()}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    train_steps = 2 * steps_per_epoch
    expected = {'k1': layers * (train_steps + 2 * valid_batches),
                'k1_gates': layers * train_steps, 'k2': layers * train_steps}
    expected.update(k1_bf16=expected['k1'] if store else 0, k2_bf16=expected['k2'] if store else 0)
    mlpg_expected = train_steps + 2 * valid_batches     # one a step and a valid batch
    if launches != expected or mlpg_launches != mlpg_expected:
        raise AssertionError(f'{phase}: launches {launches}, MLPG {mlpg_launches}, expected '
                             f'{expected}, MLPG {mlpg_expected}')
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
    with mlpg_timer(torch) as mlpg_ms:     # the MLPG of one train step
        exp.loop.train_step(features, exp.learning_rate)

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
          'mlpg_launches': mlpg_launches, 'peak_memory_mib': peak_mib})
    emit(dict({'phase': phase + '_step_breakdown', 'B': TRAIN_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'frames': float(np.sum(features['n_frames'])),
               'step_ms': step_ms, 'median_step_ms_after_first': float(np.median(step_ms[1:])),
               'mlpg_ms': mlpg_ms[0]}, **profile))
    if not mlpg_launches:
        raise AssertionError(f'{phase}: no MLPG launch')
    return launches


def time_train_steps(torch, exp):
    """Five train steps on one full batch of `exp`'s loader, host clock
    around synchronised calls, then one profiled step. Returns the batch,
    the step times in ms and the profile."""
    features = host_features(next(iter(exp.train_loader)))
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


def train_parity_phase(torch, root, model_class, phase='train_parity', seed=12, *flags,
                       loss_rtol=TRAIN_LOSS_RTOL, grad_rtol=TRAIN_GRAD_RTOL):
    """The same trainer on the GPU and on the CPU, from one init and one
    corpus: per-step losses within `loss_rtol` and the first step's
    gradients within `grad_rtol` of each one's max |value|. `flags` go to
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
            '--device', device, '--batch_size', '4', '--no-valid', '--end_epoch', '3',
            *HOST_PATH, *flags))
        exp = ExperimentBuilder(model_class, **args)
        exp.model.mode = 'train'
        losses, grads, frames = [], None, []
        for _ in range(3):
            features = host_features(next(iter(exp.train_loader)))
            # The padded length: frames, or phones for DurationModel.
            key = 'normalised_counters' if 'normalised_counters' in features else 'normalised_lab'
            frames.append(int(features[key].shape[1]))
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
          'loss_rtol': loss_rtol, 'max_grad_rel_err': grad_rel[worst],
          'worst_param': worst, 'grad_rtol': grad_rtol, 'flags': list(flags)})
    if max(loss_rel) > loss_rtol or grad_rel[worst] > grad_rtol:
        raise AssertionError(f'{phase}: GPU trainer disagrees with the CPU trainer')


KERNEL_KINDS = (('lstm_fwd_bf16_kernel', 'k1c'), ('lstm_bwd_bf16_kernel', 'k2c'),
                ('gru_fwd_bf16_kernel', 'k3c'), ('gru_bwd_simt_kernel', 'k4c'),
                ('lstm_fwd_kernel', 'k1'), ('lstm_bwd_kernel', 'k2'), ('gru_fwd_kernel', 'k3'),
                ('gru_bwd_kernel', 'k4'), ('attn_fwd_bf16_kernel', 'k5b'),
                ('attn_fwd_kernel', 'attn_fwd'), ('attn_bwd', 'attn_bwd'),
                ('rnn_dw_bf16_kernel', 'carry'), ('mlpg_kernel', 'mlpg'))


def kernel_kind(name):
    """The part of a step a device kernel belongs to, by its name."""
    for key, kind in KERNEL_KINDS:
        if key in name:
            return kind
    lower = name.lower()
    if 'gemm' in lower or 'nvjet' in lower:   # cuBLAS's Hopper GEMMs include nvjet_* kernels
        return 'gemm'
    if 'multi_tensor_apply' in lower or 'adam' in lower:
        return 'adam'
    return 'other'


PROFILE_MARGIN_S = 0.02    # idle host time at each end of a profiled call

# The profiler's kinds whose kernels a wrapper's counter counts one for one:
# kind -> (the counters of bf16_counters() that it adds, those it takes away).
COUNTED_KINDS = {'k3c': (('k3c',), ()), 'k4c': (('k4c',), ()), 'k3': (('k3',), ('k3c',)),
                 'k4': (('k4',), ('k4c',)), 'k1c': (('k1c_cluster',), ()),
                 'k2c': (('k2c_cluster',), ()), 'k1': (('k1',), ('k1c_cluster',)),
                 'k2': (('k2',), ('k2c_cluster',)), 'k5b': (('k5b',), ())}


def profile_step(torch, fn, counted=True):
    """One profiled call of `fn`, after a first call with the tracer already
    on (the profiler's warm-up step, whose events it drops, so that the
    call's first kernels are traced): device time by kernel (K1-K4, K1c and
    K2c's cluster kernels, K3c and K4c, the attention forward (K5b apart)
    and backward,
    the bf16 carry, GEMMs, Adam's multi-tensor kernels, the rest), the
    number of kernels, and the host ops that took the most time. With
    `counted`, the kernels of each kind in COUNTED_KINDS are held to the
    launches its wrappers counted in the call: a kind whose traced kernels
    differ from them reports its device ms as 'not measured' and both
    counts under 'launch_mismatch'. Device time counts kernels only: the
    device-side ranges of annotations (the profiler's step, the
    optimizer's record_function) span kernels counted on their own, and
    are reported apart as annotations_device_ms. The table by device time
    goes to stderr."""
    from torch.profiler import ProfilerActivity, profile, schedule

    counters = bf16_counters()

    def counts():
        return {key: getattr(module, name) for key, (module, name) in counters.items()}

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        # The tracer keeps the device's events inside its window on the
        # host's clock: an idle margin at each end keeps the call's first
        # and last kernels in it.
        time.sleep(PROFILE_MARGIN_S)
        before = counts()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        after = counts()
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    events = prof.key_averages()
    kernels, annotation_us = [], 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, 'is_user_annotation', False) or e.name.startswith('ProfilerStep'):
            annotation_us += e.self_device_time_total
        else:
            kernels.append(e)
    kinds = [kind for _, kind in KERNEL_KINDS] + ['gemm', 'adam', 'other']
    device_us, traced = dict.fromkeys(kinds, 0.0), dict.fromkeys(kinds, 0)
    for e in kernels:
        device_us[kernel_kind(e.name)] += e.self_device_time_total
        traced[kernel_kind(e.name)] += 1
    busy_ms = sum(device_us.values()) / 1e3
    out = {f'{kind}_device_ms': us / 1e3 for kind, us in device_us.items()}
    mismatch = {}
    for kind, (plus, minus) in COUNTED_KINDS.items() if counted else ():
        launched = sum(after[k] - before[k] for k in plus) - sum(after[k] - before[k]
                                                                 for k in minus)
        if launched != traced[kind]:
            mismatch[kind] = {'traced': traced[kind], 'launched': launched}
            out[f'{kind}_device_ms'] = 'not measured'
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    print(events.table(sort_by='self_device_time_total', row_limit=15), file=sys.stderr)
    return {'profiled_wall_ms': wall_ms,
            'device_busy_ms': busy_ms if kernels else 'not measured',
            'device_idle_share': 1 - busy_ms / wall_ms if kernels else 'not measured',
            **out, 'launch_mismatch': mismatch, 'annotations_device_ms': annotation_us / 1e3,
            'kernels_launched': len(kernels),
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


def cpu_held_batch(items):
    """Of the batches of SERVE_BATCH that predict_items serves `items` in
    (in their order), the one of the shortest padded length: the CPU engine
    serves it whole, so both engines pad it alike (a MoE block's expert
    capacity depends on the batch's padded length) and the card's timed
    outputs are held as they came."""
    batches = [items[i:i + SERVE_BATCH] for i in range(0, len(items), SERVE_BATCH)]
    return min(batches, key=lambda b: max(int(it['n_frames'].reshape(-1)[0]) for it in b))


def engine_serving_phase(torch, root, model_class, phase, label, make, dims, ops, name, layers,
                         seed, model_kwargs=None, prepare=None, mlpg_per_batch=1):
    """`model_class` (with `model_kwargs`) at full width, seeded weights and
    normaliser statistics (and what `prepare(root, rng)` writes beside
    them), served by InferenceEngine.predict_items: the utterances of `make`
    at B=16; shapes and finiteness of the outputs in `dims`, `layers`
    forward launches per batch of the kernel counted by `ops` (reported as
    `name`; None for a model without one) and none of its backward,
    `mlpg_per_batch` MLPG launches a batch, the timed outputs of one batch
    against the CPU engine's (cpu_held_batch), throughput, peak memory and
    where a batch's time goes."""
    from morgana_tpu_torch import data
    from morgana_tpu_torch.ops import mlpg as mlpg_ops
    from morgana_tpu_torch.serve import InferenceEngine

    serve_root = os.path.join(root, phase)
    os.makedirs(serve_root)
    rng = np.random.default_rng(seed)
    ckpt = seeded_checkpoint(torch, model_class, os.path.join(serve_root, 'epoch_1.npz'), seed,
                             **(model_kwargs or {}))
    write_normalisers(serve_root, rng)
    if prepare is not None:
        prepare(serve_root, rng)
    items = make(rng)

    engine = InferenceEngine(model_class, ckpt, data_root=serve_root, batch_size=SERVE_BATCH,
                             model_kwargs=model_kwargs)
    engine.predict_items(items[:2])   # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    if ops is not None:
        ops.launches = ops.bwd_launches = 0
    solves, fused = mlpg_ops.launches, mlpg_ops.fused_launches
    start = time.perf_counter()
    outputs = engine.predict_items(items)      # returns host arrays: ends synchronised
    seconds = time.perf_counter() - start
    launches, bwd_launches = (0, 0) if ops is None else (ops.launches, ops.bwd_launches)
    solves, fused = mlpg_ops.launches - solves, mlpg_ops.fused_launches - fused
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
    mlpg_expected = mlpg_per_batch * n_batches
    if launches != expected or bwd_launches or solves != mlpg_expected \
            or fused != mlpg_expected:
        raise AssertionError(f'{name} launched {launches} times (backward {bwd_launches}), '
                             f'the MLPG solve {solves}, for {n_batches} batches, expected '
                             f'{expected} (backward 0) and {mlpg_expected}')

    # The same checkpoint on the CPU (plain versions) for the timed batch
    # of the shortest padded length, against the card's timed outputs.
    held = cpu_held_batch(items)
    cpu = InferenceEngine(model_class, ckpt, data_root=serve_root, device='cpu',
                          batch_size=SERVE_BATCH, model_kwargs=model_kwargs).predict_items(held)
    errs = {}
    for key in dims:
        net = key.startswith('normalised') or key == 'vuv'
        worst = 0.0
        for it in held:
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
        engine.model.predict(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mlpg_timer(torch) as mlpg_ms:
            engine.model.predict(batch)
        predict_ms = (time.perf_counter() - t0) * 1e3
        profile = profile_step(torch, lambda: engine.model.predict(batch))
    emit(dict({'phase': phase, 'model': label,
               'utterances': N_UTTS, 'frames': frames, 'batch_size': SERVE_BATCH,
               'batches': n_batches, 'seconds': seconds, 'utterances_per_s': N_UTTS / seconds,
               'frames_per_s': frames / seconds, 'ms_per_batch': seconds / n_batches * 1e3,
               'peak_memory_mib': peak_mib,
               **({f'{name}_launches': launches, f'{name}_launches_expected': expected}
                  if ops is not None else {}), 'mlpg_solve_launches': solves,
               'mlpg_launches': fused,
               'gpu_vs_cpu_err': errs, 'gpu_vs_cpu_utterances': len(held),
               'net_tol': NET_TOL, 'traj_rtol': TRAJ_RTOL,
               'profiled_batch_T': int(features['normalised_counters'].shape[1]),
               'predict_ms': predict_ms, 'mlpg_ms': mlpg_ms[0]},
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
    with mlpg_timer(torch) as mlpg_ms:     # the MLPG of one train step
        exp.loop.train_step(features, exp.learning_rate)
    emit(dict({'phase': 'transformer_train_step_breakdown', 'B': TRAIN_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'frames': float(np.sum(features['n_frames'])), 'step_ms': step_ms,
               'median_step_ms_after_first': float(np.median(step_ms[1:])),
               'epoch_2_frames_per_s': frames_per_s,
               'mlpg_ms': mlpg_ms[0]}, **profile))
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
                        *flags, model_kwargs=None, corpus=None, mlpg_per_step=1):
    """Trains `model_class` (with `model_kwargs`) for 2 epochs with
    validation through the ExperimentBuilder on the train corpus (or the
    one `corpus(root)` writes), from a seeded epoch_0.npz; checks the
    launches of the kernels counted by `ops` (its `launches` and
    `bwd_launches`, reported under `names`; None for a model without one):
    `layers` (the number of `layer_class` modules) of each per train step
    and forward ones alone per valid batch, and `mlpg_per_step` MLPG
    launches per train step and per valid batch; finite losses and metrics
    and the checkpoint's strict reload. Returns the launches, the experiment
    and its directory."""
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder
    from morgana_tpu_torch.ops import mlpg as mlpg_ops

    data_root, corpus_s = (corpus or train_corpus)(root)
    kwargs = model_kwargs or {}
    ckpt = seeded_checkpoint(torch, model_class, os.path.join(root, f'{phase}_init', 'epoch_0.npz'),
                             seed, **kwargs)
    if kwargs:
        flags += ('--model_kwargs', repr(kwargs))
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
    if ops is not None:
        ops.launches = ops.bwd_launches = 0
    mlpg_before = mlpg_ops.fused_launches
    start = time.perf_counter()
    exp.run_experiment()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    mlpg_launches = mlpg_ops.fused_launches - mlpg_before
    fwd, bwd = names
    launches = {fwd: 0, bwd: 0} if ops is None else {fwd: ops.launches, bwd: ops.bwd_launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    train_steps = 2 * steps_per_epoch
    expected = {fwd: 0, bwd: 0} if ops is None else {
        fwd: layers * (train_steps + 2 * valid_batches), bwd: layers * train_steps}
    mlpg_expected = mlpg_per_step * (train_steps + 2 * valid_batches)
    if launches != expected or mlpg_launches != mlpg_expected:
        raise AssertionError(f'{phase}: launches {launches}, MLPG {mlpg_launches}, expected '
                             f'{expected}, MLPG {mlpg_expected}')
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
    nn.load_jax_params(model_class(**kwargs),
                       np.load(os.path.join(exp_dir, 'checkpoints', 'epoch_2.npz')))
    emit({'phase': phase, 'model': model_class.__name__, 'model_kwargs': kwargs,
          'corpus': '64 train + 16 valid, n_phones 40-119, dur 5-9', 'corpus_seconds': corpus_s,
          'batch_size': TRAIN_BATCH, 'epochs': 2, 'steps_per_epoch': steps_per_epoch,
          'valid_batches': valid_batches, 'run_seconds': run_s, 'step_losses': step_losses,
          'train_metrics': {k: v for k, v in epoch_metrics.items() if k.startswith('train')},
          'valid_metrics': {k: v for k, v in epoch_metrics.items() if k.startswith('valid')},
          'layers': layers, 'mlpg_launches': mlpg_launches,
          'mlpg_launches_expected': mlpg_expected, 'peak_memory_mib': peak_mib,
          **({} if ops is None else {
              'launches': launches, 'launches_expected': expected,
              f'{fwd}_launches_per_train_step':
                  (launches[fwd] - 2 * layers * valid_batches) / train_steps,
              f'{fwd}_launches_per_valid_batch': layers,
              f'{bwd}_launches_per_train_step': launches[bwd] / train_steps})})
    return launches, exp, exp_dir


def gru_train_phase(torch, root, model_class, phase, layers, seed, *flags, mlpg_per_step=1):
    """builder_train_phase for a GRU model: K3 and K4, one each per GRU
    layer."""
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.ops import gru as gru_ops

    return builder_train_phase(torch, root, model_class, phase, gru_ops, ('k3', 'k4'),
                               nn.Recurrent, layers, seed, *flags, mlpg_per_step=mlpg_per_step)


def f0_train_phase(torch, root, smi):
    """F0Model through gru_train_phase with the builder's defaults but
    --valid_output_interval 1 (its validation analysis synthesises a wav per
    valid utterance each epoch: f0_valid_synth_check), then steady-state
    steps on one full batch, one profiled step and the MLPG's share of it."""
    from morgana_tpu_torch.models.f0_test_model import F0Model

    launches, exp, exp_dir = gru_train_phase(torch, root, F0Model, 'f0_train', F0_LAYERS, 21,
                                             '--valid_output_interval', '1')
    f0_valid_synth_check(exp_dir, smi)
    features, step_ms, profile = time_train_steps(torch, exp)
    with mlpg_timer(torch) as mlpg_ms:     # the MLPG of one train step
        exp.loop.train_step(features, exp.learning_rate)
    emit(dict({'phase': 'f0_train_step_breakdown', 'B': TRAIN_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'frames': float(np.sum(features['n_frames'])),
               'step_ms': step_ms, 'median_step_ms_after_first': float(np.median(step_ms[1:])),
               'mlpg_ms': mlpg_ms[0]}, **profile))
    return launches


def duration_train_phase(torch, root):
    """DurationModel (GRU(128)) through gru_train_phase with its validation
    analysis every epoch; checks the feats/dur/*.npy it writes."""
    from morgana_tpu_torch.data import file_io
    from morgana_tpu_torch.models.duration_model import DurationModel

    launches, exp, exp_dir = gru_train_phase(torch, root, DurationModel, 'duration_train', 1, 22,
                                             '--valid_output_interval', '1', mlpg_per_step=0)
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
def timed_calls(torch, owner, names, sync=False, clock=time.perf_counter):
    """Sums the seconds and counts the calls of `owner`'s methods `names`
    (an instance's, or a class's for all its instances) into the yielded
    {name: [seconds, calls]}; with `sync` each call ends with
    torch.cuda.synchronize(), so that its device work is in its time. The
    seconds are `clock`'s: the wall by default, time.thread_time for the
    calling thread's CPU time."""
    spent = {name: [0.0, 0] for name in names}
    originals = {name: owner.__dict__.get(name) for name in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = clock()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            spent[name][0] += clock() - t0
            spent[name][1] += 1
            return out
        return timed

    for name in names:
        setattr(owner, name, wrap(name, getattr(owner, name)))
    try:
        yield spent
    finally:
        for name, original in originals.items():
            if original is None:
                delattr(owner, name)
            else:
                setattr(owner, name, original)


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
    from morgana_tpu_torch.data import file_io
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
    with timed_calls(torch, file_io, ('save_wav',)) as writes:
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
    split['vocoder'] = split['analysis'] - writes['save_wav'][0]
    split['writes'] = writes['save_wav'][0]
    seconds = stats['seconds']
    emit({'phase': 'generate_lstm', 'card': smi, 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
          'utterances': stats['utterances'], 'frames': stats['frames'], 'batch_size': SERVE_BATCH,
          'batches': n_batches, 'seconds': seconds, 'utterances_per_s': N_UTTS / seconds,
          'frames_per_s': stats['frames'] / seconds,
          'audio_seconds_per_s': stats['frames'] * HOP / FS / seconds,
          'split_seconds': split, 'wav_files': writes['save_wav'][1],
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
    with timed_calls(torch, file_io, ('save_wav',)) as writes:
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
          'wav_write_seconds': writes['save_wav'][0], 'k1_launches': launches,
          'k1_launches_expected': 8 * batches})
    return launches


# ------------------------------------------------ the pipeline and the stream

@contextlib.contextmanager
def vocoder_batches():
    """Records each torch_world.synthesize_batch call of the pipeline: its
    inputs as host arrays and its waves."""
    from morgana_tpu_torch.vocoder import torch_world

    calls = []
    real = torch_world.synthesize_batch

    def record(f0, vuv, mcep, bap, seq_len, sample_rate, **kwargs):
        waves, lens = real(f0, vuv, mcep, bap, seq_len, sample_rate, **kwargs)
        calls.append({'inputs': [np.array(a) for a in (f0, vuv, mcep, bap, seq_len)],
                      'device': str(kwargs.get('device')), 'waves': waves.cpu()})
        return waves, lens

    torch_world.synthesize_batch = record
    try:
        yield calls
    finally:
        torch_world.synthesize_batch = real


def pipeline_engines(torch, served, device=None):
    """The two engines of the pipeline on the serving phase's root: a seeded
    full-width DurationModel (600 -> 128 -> GRU(128) -> 1) and the serving
    phase's LSTMAcousticModel checkpoint, B=16, both reading the serving
    statistics with dur's set to PIPELINE_DUR_STATS (about 8 frames a
    phone) from root/pipeline_norm. Returns (duration engine, acoustic
    engine, the duration checkpoint, the normalisation dir)."""
    from morgana_tpu_torch.models.duration_model import DurationModel
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.serve import InferenceEngine

    root, norm = served['root'], 'pipeline_norm'
    norm_dir = os.path.join(root, norm)
    dur_ckpt = os.path.join(norm_dir, 'duration_epoch_0.npz')
    if not os.path.exists(dur_ckpt):
        shutil.copytree(os.path.join(root, 'train'), norm_dir)
        with open(os.path.join(norm_dir, 'dur_mvn.json'), 'w') as f:
            json.dump(PIPELINE_DUR_STATS, f)
        seeded_checkpoint(torch, DurationModel, dur_ckpt, PIPELINE_DUR_SEED)
    common = dict(data_root=root, normalisation_dir=norm, batch_size=SERVE_BATCH, device=device)
    return (InferenceEngine(DurationModel, dur_ckpt, **common),
            InferenceEngine(LSTMAcousticModel, served['ckpt'], **common), dur_ckpt, norm)


def label_items(items):
    """What the pipeline reads of an utterance: its name and phone labels."""
    return [{'name': item['name'], 'lab': item['lab']} for item in items]


def float_durations(engine, items):
    """The duration engine's float predictions of `items`, cut to each
    utterance's phones."""
    from morgana_tpu_torch.pipeline import TTSPipeline

    built = [{'name': it['name'], 'lab': it['lab'],
              'n_phones': np.asarray([[float(it['lab'].shape[0])]], np.float32)} for it in items]
    sources = {k: v for k, v in engine.model.test_data_sources().items()
               if k in TTSPipeline.DURATION_INPUTS}
    out = engine.predict_items(built, sources=sources)
    return {it['name']: np.asarray(out[it['name']]['dur']).reshape(-1)[:it['lab'].shape[0]]
            for it in items}


def hold_features(label, got, want, keys):
    """Each of `keys` of the {name: outputs} `got` against `want`: network
    outputs (normalised deltas, vuv) within NET_TOL abs, trajectories within
    TRAJ_RTOL of max(1, max |want|). Returns the worst error by key."""
    errs = {}
    for key in keys:
        net = key.startswith('normalised') or key == 'vuv'
        worst = 0.0
        for name in want:
            a, b = np.asarray(got[name][key]), np.asarray(want[name][key])
            if a.shape != b.shape:
                raise AssertionError(f'{label} {name} {key}: shape {a.shape} vs {b.shape}')
            err = float(np.abs(a - b).max()) if a.size else 0.0
            worst = max(worst, err if net else err / max(1.0, float(np.abs(b).max())))
        errs[key] = worst
        if worst > (NET_TOL if net else TRAJ_RTOL):
            raise AssertionError(f'{label} {key}: {worst} beyond tolerance')
    return errs


def pipeline_lstm_phase(torch, dev, served, smi):
    """TTSPipeline on the card over the 32 smoke utterances' labels at B16:
    the seeded DurationModel (K3) chained into the serving phase's
    LSTMAcousticModel (K1), once with the host vocoder and once with
    device_vocoder=True. Checks 1 K3 launch per duration batch and 8 K1
    launches per acoustic batch, 32 wavs of n_frames * 80 samples each
    time, the integer durations and the features of the 4 shortest
    utterances against the same pipeline on the CPU, the device route's one
    synthesize_batch call on the card, bit-identical when called again on
    its inputs, and each row against the same call on the CPU (the card
    generator's noise given to both; as vocoder_batch holds them). Records
    utt/s, frames/s, seconds of audio a second and the split of the
    seconds (duration stage, acoustic stage, vocoder, writes, the rest)
    for each route, and the device vocoder's card ms. Then the pipeline's
    command line once, with --device_vocoder and --evaluate_against.
    Returns the launches {'k1', 'k3'} of both runs."""
    from morgana_tpu_torch.ops import gru as gru_ops
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.pipeline import TTSPipeline
    from morgana_tpu_torch.vocoder import torch_world

    root = served['root']
    items = label_items(served['items'])
    dur_engine, ac_engine, dur_ckpt, norm = pipeline_engines(torch, served)
    # Warm-up: the host vocoder's native library, and the device route at
    # the timed shapes (cuFFT plans are made per size).
    TTSPipeline(dur_engine, ac_engine).synthesize_items(items[1:2])
    TTSPipeline(dur_engine, ac_engine, device_vocoder=True).synthesize_items(items)
    n_batches = -(-N_UTTS // SERVE_BATCH)
    launches = {'k1': 0, 'k3': 0}
    runs, results = {}, {}
    for route in ('host', 'device'):
        pipe = TTSPipeline(dur_engine, ac_engine, device_vocoder=route == 'device')
        out_dir = os.path.join(root, f'pipeline_{route}')
        with timed_calls(torch, pipe, ('predict_durations', '_synthesize_wav',
                                       '_synthesize_wavs_device', '_dump_outputs')) as split, \
                timed_calls(torch, ac_engine, ('predict_items',)) as acoustic, \
                vocoder_batches() as calls:
            torch.cuda.synchronize()
            gru_ops.launches = lstm_ops.launches = 0
            start = time.perf_counter()
            results[route] = pipe.synthesize_items(items, out_dir=out_dir)
            seconds = time.perf_counter() - start
        k1, k3 = lstm_ops.launches, gru_ops.launches
        launches['k1'] += k1
        launches['k3'] += k3
        if k1 != 8 * n_batches or k3 != n_batches:
            raise AssertionError(f'pipeline_lstm {route}: K1 launched {k1} times, K3 {k3} times '
                                 f'for {n_batches} batches (expected {8 * n_batches}, '
                                 f'{n_batches})')
        lengths = {name: out['n_frames'] for name, out in results[route].items()}
        check_wavs(f'pipeline_lstm {route}', os.path.join(out_dir, 'synth'), lengths)
        if len(calls) != (route == 'device') or (calls and calls[0]['device'] != str(dev)):
            raise AssertionError(f'pipeline_lstm {route}: synthesize_batch calls {calls}')
        frames = sum(lengths.values())
        vocoder_s = split['_synthesize_wav'][0] + split['_synthesize_wavs_device'][0]
        parts = {'duration_stage': split['predict_durations'][0],
                 'acoustic_stage': acoustic['predict_items'][0],
                 'vocoder': vocoder_s, 'writes': split['_dump_outputs'][0]}
        parts['other'] = seconds - sum(parts.values())
        runs[route] = {'seconds': seconds, 'utterances_per_s': N_UTTS / seconds,
                       'frames': frames, 'frames_per_s': frames / seconds,
                       'audio_seconds_per_s': frames * HOP / FS / seconds,
                       'split_seconds': parts, 'k1_launches': k1, 'k3_launches': k3}
        if calls:
            device_call = calls[0]
    for name, out in results['host'].items():
        if not np.array_equal(out['dur'], results['device'][name]['dur']):
            raise AssertionError(f'pipeline_lstm {name}: the two routes predicted other durations')

    # The device route's call again on its inputs (the card generator's
    # noise, as the default draws it): the same bits; then on the CPU.
    f0, vuv, mcep, bap, seq_len = device_call['inputs']
    batch, num_frames = f0.shape
    noise = torch.randn((batch, num_frames * HOP), generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev)
    args = [torch.from_numpy(a).to(dev) for a in (f0, vuv, mcep, bap, seq_len)]
    again = torch_world.synthesize_batch(*args, FS, noise=noise)[0].cpu()
    if not torch.equal(again, device_call['waves']):
        raise AssertionError('pipeline_lstm: two card runs of the device vocoder differ')
    cpu = torch_world.synthesize_batch(f0, vuv, mcep, bap, seq_len, FS, noise=noise.cpu(),
                                       device='cpu')[0]
    mask = np.arange(num_frames)[None, :] < seq_len[:, None]
    voiced_f0 = np.where(vuv > 0.5, f0, 0.0) * mask
    trains = [(torch_world.pulse_train(torch.from_numpy(voiced_f0.astype(np.float32)).to(d),
                                       FS, HOP) != 0).cpu() for d in (dev, 'cpu')]
    vs_cpu = [hold_wave(f'pipeline_lstm device vocoder row {i} vs CPU', again[i], cpu[i],
                        torch.equal(trains[0][i], trains[1][i]), VOCODER_RTOL)
              for i in range(batch)]
    card_ms = cuda_ms(torch, lambda: torch_world.synthesize_batch(*args, FS, noise=noise), reps=3)

    # The 4 shortest utterances through the same pipeline on the CPU.
    few = sorted(items, key=lambda it: it['lab'].shape[0])[:4]
    cpu_dur, cpu_ac, _, _ = pipeline_engines(torch, served, device='cpu')
    cpu_out = TTSPipeline(cpu_dur, cpu_ac).synthesize_items(few)
    floats = float_durations(cpu_dur, few)
    tie = min(float(np.abs(np.abs(f - np.floor(f)) - 0.5).min()) for f in floats.values())
    for it in few:
        if not np.array_equal(results['host'][it['name']]['dur'], cpu_out[it['name']]['dur']):
            raise AssertionError(f"pipeline_lstm {it['name']}: durations differ from the CPU's "
                                 f'(nearest CPU float to a .5 boundary: {tie})')
    errs = hold_features('pipeline_lstm vs CPU', results['host'], cpu_out, ACOUSTIC_DIMS)

    # The command line once: labels -> wavs on the card, scored against the
    # corpus split it read.
    write_items(root, 'pipeline', served['items'], ac_engine.model.test_data_sources())
    cli_dir = os.path.join(root, 'pipeline_cli')
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'morgana_tpu_torch.pipeline', '--duration_model',
         'morgana_tpu_torch.models.duration_model:DurationModel', '--duration_checkpoint',
         dur_ckpt, '--acoustic_model', 'morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel',
         '--acoustic_checkpoint', served['ckpt'], '--data_root', root, '--normalisation_dir',
         norm, '--data_dir', 'pipeline', '--out_dir', cli_dir, '--batch_size', str(SERVE_BATCH),
         '--device_vocoder', '--evaluate_against', os.path.join(root, 'pipeline')],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f'pipeline_lstm: the pipeline CLI exited {proc.returncode}\n'
                             f'{proc.stderr[-4000:]}')
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    if cli['utterances'] != N_UTTS or cli['wavs'] != N_UTTS or 'evaluation' not in cli:
        raise AssertionError(f'pipeline_lstm: the pipeline CLI printed {cli}')
    check_wavs('pipeline_lstm cli', os.path.join(cli_dir, 'synth'),
               {name: out['n_frames'] for name, out in results['device'].items()})

    emit({'phase': 'pipeline_lstm', 'card': smi,
          'models': 'DurationModel 600-GRU(128)-1 -> LSTMAcousticModel 609-8xLSTM(512)-199',
          'utterances': N_UTTS, 'batch_size': SERVE_BATCH, 'batches': n_batches,
          'phones': int(sum(it['lab'].shape[0] for it in items)),
          'dur_stats': PIPELINE_DUR_STATS, 'host_vocoder': runs['host'],
          'device_vocoder': dict(runs['device'], card_ms=card_ms, B=batch, T=num_frames,
                                 card_runs_bit_identical=True,
                                 max_vs_cpu={k: max(abs(a[k]) for a in vs_cpu)
                                             for k in vs_cpu[0]}),
          'host': "the vocoder's host route, MLPG, the writes and the pipeline's glue run on "
                  "the card machine's CPU",
          'cpu_check': {'utterances': [it['name'] for it in few], 'durations_equal': True,
                        'nearest_cpu_duration_to_a_tie': tie, 'max_err': errs,
                        'net_tol': NET_TOL, 'traj_rtol': TRAJ_RTOL},
          'cli': {'seconds': cli_s, 'seconds_inside': cli['seconds'],
                  'frames_per_sec_inside': cli['frames_per_sec'],
                  'evaluation': cli['evaluation']}})
    return launches


def stream_chunk_case(torch, dev, seed):
    """K1 as a streamed chunk runs it, through lstm_layer: B=1, T =
    STREAM_CONFIG's chunk, H=512, an initial state (the previous chunk's),
    no seq_len; against the plain layer within KERNEL_TOL, and timed beside
    its plain version, the layer and cuDNN, with its bound."""
    from morgana_tpu_torch.ops import lstm as lstm_ops

    steps = STREAM_CONFIG[0]
    x, (w_ih, w_hh, b_ih, b_hh), _, h0, c0 = layer_inputs(torch, dev, 1, steps, True, seed)
    cudnn = cudnn_layer(torch, dev, w_ih, w_hh, b_ih, b_hh)
    with torch.inference_mode():
        before = lstm_ops.launches
        y_k, (hn_k, cn_k) = lstm_ops.lstm_layer(x, w_ih, w_hh, b_ih, b_hh, h0=h0, c0=c0)
        torch.cuda.synchronize()
        launched = lstm_ops.launches - before
        y_p, (hn_p, cn_p) = lstm_ops.lstm_layer_reference(x, w_ih, w_hh, b_ih, b_hh, h0=h0, c0=c0)
        err = max(max_abs(a - b) for a, b in ((y_k, y_p), (hn_k, hn_p), (cn_k, cn_p)))
        xg = (torch.matmul(x, w_ih) + (b_ih + b_hh)).transpose(0, 1).contiguous()
        hx = (h0[None].contiguous(), c0[None].contiguous())
        out = {'phase': 'k1_stream_chunk', 'B': 1, 'T': steps, 'H': H, 'initial_state': True,
               'max_abs_err_vs_plain': err, 'tolerance': KERNEL_TOL, 'launches': launched,
               'kernel_ms': cuda_ms(torch, lambda: lstm_ops.lstm_recurrence(xg, w_hh, h0, c0), 20),
               'plain_ms': cuda_ms(torch, lambda: lstm_ops.lstm_recurrence_reference(
                   xg, w_hh, h0, c0), 3),
               'layer_ms': cuda_ms(torch, lambda: lstm_ops.lstm_layer(
                   x, w_ih, w_hh, b_ih, b_hh, h0=h0, c0=c0), 20),
               'library_ms': cuda_ms(torch, lambda: cudnn(x, hx), 20)}
    out['bound_ms'], out['bound_by'] = k1_bound(1, steps, H)
    out['us_per_step'] = out['kernel_ms'] * 1e3 / steps
    emit(out)
    if err > KERNEL_TOL or launched != 1:
        raise AssertionError(f'K1 disagrees on a streamed chunk: {out}')
    return out


@contextlib.contextmanager
def stream_timers(torch, model, keys):
    """Times a stream's parts: the model's stream_step (synchronised, so
    its device work is in its time; the host copy that follows is then
    nearly free), the StreamingMLPG solves and the StreamingSynthesizer
    pushes; and keeps the `keys` outputs of every chunk (on the device).
    Yields {'outputs': [{key: (C, D)}], part: {method: [seconds, calls]}}
    for the parts 'model', 'mlpg' and 'vocoder'."""
    from morgana_tpu_torch.streaming import StreamingMLPG
    from morgana_tpu_torch.vocoder import StreamingSynthesizer

    kept = []
    step = model.stream_step

    def keep(chunk, state):
        outputs, state = step(chunk, state)
        kept.append({key: outputs[key][0] for key in keys})
        return outputs, state

    model.stream_step = keep
    try:
        with timed_calls(torch, model, ('stream_step',), sync=True) as model_s, \
                timed_calls(torch, StreamingMLPG, ('push', 'flush')) as mlpg_s, \
                timed_calls(torch, StreamingSynthesizer, ('push_world_feats', 'flush')) as voc_s:
            yield {'outputs': kept, 'model': model_s, 'mlpg': mlpg_s, 'vocoder': voc_s}
    finally:
        del model.stream_step


def chunk_ms(rec, chunks, parts=('model', 'mlpg', 'vocoder')):
    """Mean ms a chunk of each part that stream_timers timed."""
    return {part: sum(t[0] for t in rec[part].values()) / chunks * 1e3 for part in parts}


def streamed(torch, chunks, n_frames, keys):
    """The kept stream_step outputs of a stream, concatenated and cut at
    n_frames, as host arrays."""
    return {key: torch.cat([c[key] for c in chunks])[:n_frames].cpu().numpy() for key in keys}


def stream_lstm_phase(torch, dev, served, smi):
    """TTSPipeline.stream_audio on the card for the STREAM_UTTS utterances
    with the most phones, at STREAM_CONFIG: labels -> durations (1 K3
    launch) -> 8 K1 launches a chunk, each with the previous chunk's state
    -> the streamed MLPG and vocoder on the host. Checks the launches, the
    audio length (n_frames * 80), the network outputs of every chunk
    against the same card engine's batch predict of the utterance within
    NET_TOL, the streamed features against it within STREAM_TRAJ_ATOL
    (vuv NET_TOL), and the shortest of them streamed on the CPU (features
    within NET_TOL / TRAJ_RTOL of the card's stream); then one K1 chunk
    against its plain version (stream_chunk_case). Records the time to the
    first audio, ms a chunk split into model, MLPG and vocoder, and the
    real-time factor. Returns K1's and K3's launches."""
    from morgana_tpu_torch.ops import gru as gru_ops
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.pipeline import TTSPipeline

    chunk_frames = STREAM_CONFIG[0]
    items = label_items(served['items'])
    longest = sorted(items, key=lambda it: -it['lab'].shape[0])[:STREAM_UTTS]
    dur_engine, ac_engine, _, _ = pipeline_engines(torch, served)
    pipe = TTSPipeline(dur_engine, ac_engine)
    sources = pipe._stage_sources(ac_engine, pipe.ACOUSTIC_INPUTS)
    list(pipe.stream_audio(items[1], *STREAM_CONFIG)[1])      # warm-up
    launches = {'k1': 0, 'k3': 0}
    per_utt, built, streams = [], {}, {}
    for item in longest:
        name = item['name']
        with stream_timers(torch, ac_engine.model, NET_OUTPUTS) as rec:
            torch.cuda.synchronize()
            gru_ops.launches = lstm_ops.launches = 0
            start = time.perf_counter()
            dur, gen = pipe.stream_audio(item, *STREAM_CONFIG)
            durations_s = time.perf_counter() - start
            first, pairs = None, []
            for feats, wav in gen:
                if first is None and wav.shape[0]:
                    first = time.perf_counter() - start
                pairs.append((feats, wav))
            seconds = time.perf_counter() - start
        n_frames = int(dur.sum())
        chunks = -(-n_frames // chunk_frames)
        k1, k3 = lstm_ops.launches, gru_ops.launches
        launches['k1'] += k1
        launches['k3'] += k3
        if k1 != 8 * chunks or k3 != 1:
            raise AssertionError(f'stream_lstm {name}: K1 launched {k1} times for {chunks} '
                                 f'chunks, K3 {k3} times')
        audio = np.concatenate([w for _, w in pairs])
        if audio.shape != (n_frames * HOP,) or not np.isfinite(audio).all():
            raise AssertionError(f'stream_lstm {name}: audio {audio.shape}, expected '
                                 f'({n_frames * HOP},)')
        streams[name] = {k: np.concatenate([c[k] for c, _ in pairs if c])
                         for k in ('lf0', 'vuv', 'mcep', 'bap')}
        streams[name].update(streamed(torch, rec['outputs'], n_frames, NET_OUTPUTS))
        built[name] = pipe._acoustic_item(name, item['lab'], dur)
        per_utt.append({'utterance': name, 'frames': n_frames, 'chunks': chunks,
                        'audio_seconds': n_frames * HOP / FS, 'seconds': seconds,
                        'durations_ms': durations_s * 1e3,
                        'time_to_first_audio_ms': first * 1e3,
                        'ms_per_chunk': chunk_ms(rec, chunks),
                        'real_time_factor': n_frames * HOP / FS / seconds,
                        'k1_launches': k1, 'k3_launches': k3})
    batch = ac_engine.predict_items(list(built.values()), sources=sources)
    errs = hold_features('stream_lstm network vs batch', streams, batch, NET_OUTPUTS)
    vs_batch = {key: max(float(np.abs(streams[n][key] - batch[n][key]).max()) for n in streams)
                for key in STREAM_TRAJ_ATOL}
    if any(vs_batch[key] > atol for key, atol in STREAM_TRAJ_ATOL.items()):
        raise AssertionError(f'stream_lstm: streamed trajectories vs batch {vs_batch} beyond '
                             f'{STREAM_TRAJ_ATOL}')

    shortest = min(built, key=lambda n: built[n]['counters'].shape[0])
    _, cpu_ac, _, _ = pipeline_engines(torch, served, device='cpu')
    cpu_stream = {shortest: {k: np.concatenate([c[k] for c in cpu_ac.stream_item(
        built[shortest], *STREAM_CONFIG, sources=sources)]) for k in ('lf0', 'vuv', 'mcep', 'bap')}}
    vs_cpu = hold_features('stream_lstm vs CPU stream', streams, cpu_stream,
                           ('lf0', 'vuv', 'mcep', 'bap'))
    chunk_case = stream_chunk_case(torch, dev, 92)

    def mean(key):
        return float(np.mean([u[key] for u in per_utt]))
    emit({'phase': 'stream_lstm', 'card': smi,
          'models': 'DurationModel 600-GRU(128)-1 -> LSTMAcousticModel 609-8xLSTM(512)-199',
          'config': dict(zip(('chunk_frames', 'context', 'lookahead'), STREAM_CONFIG)),
          'utterances': per_utt, 'time_to_first_audio_ms': mean('time_to_first_audio_ms'),
          'ms_per_chunk': {part: float(np.mean([u['ms_per_chunk'][part] for u in per_utt]))
                           for part in per_utt[0]['ms_per_chunk']},
          'real_time_factor': sum(u['audio_seconds'] for u in per_utt)
          / sum(u['seconds'] for u in per_utt),
          'host': "the streamed MLPG and the vocoder run on the card machine's CPU",
          'network_vs_batch': errs, 'trajectories_vs_batch': vs_batch,
          'trajectory_atol_vs_batch': STREAM_TRAJ_ATOL, 'cpu_stream_check': {
              'utterance': shortest, **vs_cpu}, 'k1_chunk_kernel_ms': chunk_case['kernel_ms'],
          'k1_chunk_bound_ms': chunk_case['bound_ms']})
    return launches


def stream_transformer_phase(torch, dev, served, smi):
    """The causal TransformerAcousticModel at its default widths (window 256)
    with seeded weights, on the serving phase's statistics: the
    STREAM_UTTS longest utterances predicted in one batch (6 launches of
    the attention kernel, causal with the window) and streamed at
    STREAM_CONFIG through the KV caches (the plain attention step, no
    kernel launch, as in JAX). Checks the network outputs of every chunk
    against the batch within NET_TOL, and the shortest of them streamed on
    the CPU (within NET_TOL / TRAJ_RTOL). The streamed trajectories'
    distance from the batch's is recorded, not held: with these random
    weights the outputs are rough enough that a window of 32 + 64 + 16
    frames strays from the whole-utterance solve. So that distance is also
    taken on the CPU for the shortest utterance, streamed and predicted
    whole there, beside the card's for the same utterance: equal gaps put
    it on the window solve, not on the card. Records ms a chunk (model,
    MLPG) and frames/s. Returns the attention forward's launches."""
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
    from morgana_tpu_torch.ops import flash_attention as fa
    from morgana_tpu_torch.pipeline import TTSPipeline
    from morgana_tpu_torch.serve import InferenceEngine

    root = served['root']
    kwargs = {'causal': True}
    ckpt = seeded_checkpoint(torch, TransformerAcousticModel,
                             os.path.join(root, 'causal_transformer', 'epoch_0.npz'), 45, **kwargs)
    engine = InferenceEngine(TransformerAcousticModel, ckpt, data_root=root,
                             batch_size=SERVE_BATCH, model_kwargs=kwargs)
    sources = {k: v for k, v in engine.model.test_data_sources().items()
               if k in TTSPipeline.ACOUSTIC_INPUTS}
    longest = sorted(served['items'], key=lambda it: -int(it['n_frames'].reshape(-1)[0]))
    longest = longest[:STREAM_UTTS]
    list(engine.stream_item(served['items'][1], *STREAM_CONFIG, sources=sources))  # warm-up
    torch.cuda.synchronize()
    fa.launches = 0
    batch = engine.predict_items(longest, sources=sources)
    batch_launches = fa.launches
    if batch_launches != TRANSFORMER_BLOCKS:
        raise AssertionError(f'stream_transformer: the attention kernel launched '
                             f'{batch_launches} times for one batch')
    streams, per_utt = {}, []
    for item in longest:
        name, n_frames = item['name'], int(item['n_frames'].reshape(-1)[0])
        with stream_timers(torch, engine.model, NET_OUTPUTS) as rec:
            torch.cuda.synchronize()
            fa.launches = 0
            start = time.perf_counter()
            chunks = list(engine.stream_item(item, *STREAM_CONFIG, sources=sources))
            seconds = time.perf_counter() - start
        if fa.launches:
            raise AssertionError(f'stream_transformer: the stream launched the attention '
                                 f'kernel {fa.launches} times')
        streams[name] = {k: np.concatenate([c[k] for c in chunks])
                         for k in ('lf0', 'vuv', 'mcep', 'bap')}
        streams[name].update(streamed(torch, rec['outputs'], n_frames, NET_OUTPUTS))
        n_chunks = -(-n_frames // STREAM_CONFIG[0])
        per_utt.append({'utterance': name, 'frames': n_frames, 'chunks': n_chunks,
                        'seconds': seconds, 'frames_per_s': n_frames / seconds,
                        'ms_per_chunk': chunk_ms(rec, n_chunks, ('model', 'mlpg'))})
    errs = hold_features('stream_transformer network vs batch', streams, batch, NET_OUTPUTS)
    vs_batch = {key: max(float(np.abs(streams[n][key] - batch[n][key]).max()) for n in streams)
                for key in ('lf0', 'mcep', 'bap')}
    shortest = min(longest, key=lambda it: int(it['n_frames'].reshape(-1)[0]))
    cpu = InferenceEngine(TransformerAcousticModel, ckpt, data_root=root, device='cpu',
                          model_kwargs=kwargs)
    cpu_stream = {shortest['name']: {k: np.concatenate([c[k] for c in cpu.stream_item(
        shortest, *STREAM_CONFIG, sources=sources)]) for k in ('lf0', 'vuv', 'mcep', 'bap')}}
    vs_cpu = hold_features('stream_transformer vs CPU stream', streams, cpu_stream,
                           ('lf0', 'vuv', 'mcep', 'bap'))
    cpu_batch = cpu.predict_items([shortest], sources=sources)[shortest['name']]
    same_utt = {side: {key: float(np.abs(stream[shortest['name']][key] - whole[key]).max())
                       for key in ('lf0', 'mcep', 'bap')}
                for side, stream, whole in (('card', streams, batch[shortest['name']]),
                                            ('cpu', cpu_stream, cpu_batch))}
    emit({'phase': 'stream_transformer', 'card': smi,
          'model': 'TransformerAcousticModel 609-6x(384, 4 heads, 1536)-199, causal, window 256',
          'config': dict(zip(('chunk_frames', 'context', 'lookahead'), STREAM_CONFIG)),
          'utterances': per_utt, 'attn_fwd_launches_batch': batch_launches,
          'ms_per_chunk': {part: float(np.mean([u['ms_per_chunk'][part] for u in per_utt]))
                           for part in per_utt[0]['ms_per_chunk']},
          'frames_per_s': sum(u['frames'] for u in per_utt) / sum(u['seconds'] for u in per_utt),
          'network_vs_batch': errs, 'trajectories_vs_batch_not_held': vs_batch,
          'trajectories_vs_batch_same_utterance': {'utterance': shortest['name'], **same_utt},
          'cpu_stream_check': {'utterance': shortest['name'], **vs_cpu}})
    return batch_launches


def http_request(port, path, payload=None):
    """(status, JSON reply, headers) of a GET (no payload) or a POST to the
    server on 127.0.0.1:`port`."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}', data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def post_bytes(port, path, data):
    """(status, reply bytes) of a POST of ready-encoded JSON: a client that
    parses nothing, as one in another process would cost the server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}', data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def json_item(item):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in item.items()}


def hold_reply(label, got, want):
    """A /predict reply's outputs against the engine's own (host arrays):
    each within HTTP_RTOL / HTTP_ATOL. Returns the largest abs error."""
    worst = 0.0
    for key, value in want.items():
        a = np.asarray(got[key], np.float32)
        if a.shape != value.shape or not np.allclose(a, value, rtol=HTTP_RTOL, atol=HTTP_ATOL):
            raise AssertionError(f'{label} {key}: reply {a.shape} vs {value.shape}, max err '
                                 f'{float(np.abs(a - value).max()) if a.shape == value.shape else None}')
        worst = max(worst, float(np.abs(a - value).max()))
    return worst


@contextlib.contextmanager
def running_server(engine, **kwargs):
    """http_serve.make_server on 127.0.0.1, a free port, serving on a thread;
    shut and closed (watcher and batchers too) on the way out."""
    import threading

    from morgana_tpu_torch import http_serve

    server = http_serve.make_server(engine, host='127.0.0.1', port=0, **kwargs)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=HTTP_TIMEOUT)


@contextlib.contextmanager
def group_sizes(engine):
    """Records the size of every engine call the batcher makes, and its
    padded rows (the '__dynpad' filler items), into the yielded list of
    (rows, padded rows)."""
    groups = []
    call = engine.predict_items

    def record(items, sources=None):
        groups.append((len(items), sum(str(it['name']).startswith('__dynpad') for it in items)))
        return call(items, sources=sources)

    engine.predict_items = record
    try:
        yield groups
    finally:
        del engine.predict_items


@contextlib.contextmanager
def request_split(torch, server, engine):
    """Where the /predict requests made inside go, summed: 'json_decode'
    (the body parsed, its items made arrays), 'predict' (the engine's
    predict_items, synchronised) and 'json_encode' (the outputs made lists,
    serialised and written). Fills the yielded dict on the way out with
    {'wall_s': {part: s}, 'cpu_s': {part: s}}: wall seconds, and the CPU
    seconds of the threads that ran each part (concurrent wall seconds
    overlap, and include waits for the interpreter lock)."""
    from morgana_tpu_torch import http_serve

    split, timers = {}, {}
    with contextlib.ExitStack() as stack:
        for label, clock in (('wall_s', time.perf_counter), ('cpu_s', time.thread_time)):
            timers[label] = [stack.enter_context(timed_calls(torch, owner, names, sync, clock))
                             for owner, names, sync in (
                                 (server.RequestHandlerClass, ('_read_json', '_reply'), False),
                                 (http_serve, ('_to_arrays', '_to_lists'), False),
                                 (engine, ('predict_items',), True))]
        yield split
    for label, (handler, convert, predict) in timers.items():
        split[label] = {'json_decode': handler['_read_json'][0] + convert['_to_arrays'][0],
                        'predict': predict['predict_items'][0],
                        'json_encode': handler['_reply'][0] + convert['_to_lists'][0]}


def percentiles(values):
    return {'p50': float(np.percentile(values, 50)), 'p95': float(np.percentile(values, 95))}


def http_serve_phase(torch, served, smi):
    """The HTTP server (http_serve.make_server on 127.0.0.1, dynamic batching
    HTTP_BATCH_MS) over the serving phase's full-width LSTMAcousticModel
    checkpoint and its 32 utterances, in five parts, each counting launches
    from 0: sequential (32 one-utterance /predict, 8 K1 launches each, every
    reply within HTTP_RTOL / HTTP_ATOL of the same engine's predict_items;
    p50/p95 of /stats, utt/s); concurrent (32 clients at once: dispatch
    groups, requests coalesced, mean group, padded rows, utt/s, p50/p95, and
    the seconds of JSON decoding, of predict on the device, synchronised,
    and of JSON encoding); stream (/stream with audio on the longest
    utterance: the int16 samples equal to clip(stream_item_audio * 32767) of
    the same engine; time to the first NDJSON line, real-time factor);
    hot reload (a second seeded epoch_2.npz beside the served one while
    RELOAD_CLIENTS clients post ready-encoded bodies and read the replies
    without parsing them, as clients in other processes cost the server,
    and a /stream is paused in its vocoder: no
    error, /healthz names it within RELOAD_DEADLINE s (and the seconds the
    watcher's reload_checkpoint took are recorded), replies after the
    switch within tolerance of the new weights' predict_items, the stream
    frame for frame the old weights' stream); fleet ({lstm, f0,
    transformer}: F0Model and TransformerAcousticModel seeded at their
    default widths; each voice's reply its engine's, 8 K1, 3 K3 and 6
    attention launches for one request each; an unknown voice 404).
    Returns the launches of K1, K3 and the attention forward."""
    import threading

    from morgana_tpu_torch.models.f0_test_model import F0Model
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
    from morgana_tpu_torch.ops import flash_attention as fa
    from morgana_tpu_torch.ops import gru as gru_ops
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.serve import InferenceEngine
    from morgana_tpu_torch.vocoder import StreamingSynthesizer

    root, items = served['root'], served['items']
    http_root = os.path.join(root, 'http')
    os.makedirs(http_root)
    ckpt = shutil.copy(served['ckpt'], os.path.join(http_root, 'epoch_1.npz'))
    engine = InferenceEngine(LSTMAcousticModel, ckpt, data_root=root, batch_size=SERVE_BATCH)
    direct = engine.predict_items(items)
    by_name = {item['name']: item for item in items}
    bodies = {item['name']: {'items': [json_item(item)]} for item in items}
    frames = sum(int(item['n_frames'].reshape(-1)[0]) for item in items)
    launches = {'k1': 0, 'k3': 0, 'attn': 0}
    out = {'phase': 'http_serve', 'card': smi, 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
           'utterances': N_UTTS, 'frames': frames, 'dynamic_batch_ms': HTTP_BATCH_MS,
           'rtol': HTTP_RTOL, 'atol': HTTP_ATOL}

    # Sequential: one request at a time.
    with running_server(engine, dynamic_batch_ms=HTTP_BATCH_MS) as server, \
            request_split(torch, server, engine) as split:
        port = server.server_address[1]
        lstm_ops.launches = 0
        worst = 0.0
        start = time.perf_counter()
        for item in items:
            before = lstm_ops.launches
            code, reply, _ = http_request(port, '/predict', bodies[item['name']])
            if code != 200 or lstm_ops.launches - before != 8:
                raise AssertionError(f"http sequential {item['name']}: {code}, K1 launched "
                                     f'{lstm_ops.launches - before} times, expected 8')
            worst = max(worst, hold_reply('http sequential', reply['results'][item['name']],
                                          direct[item['name']]))
        seconds = time.perf_counter() - start
        stats = http_request(port, '/stats')[1]
        k1 = lstm_ops.launches
    launches['k1'] += k1
    out['sequential'] = {'seconds': seconds, 'utterances_per_s': N_UTTS / seconds,
                         'frames_per_s': frames / seconds, 'latency_ms': stats['latency_ms'],
                         'k1_launches': k1, 'max_abs_err': worst,
                         'dispatch_groups': stats['dynamic_batching']['dispatch_groups'],
                         'split_ms_per_request': {label: {part: v / N_UTTS * 1e3
                                                          for part, v in parts.items()}
                                                  for label, parts in split.items()}}

    # Concurrent: every utterance at once, one client each.
    with running_server(engine, dynamic_batch_ms=HTTP_BATCH_MS) as server, \
            group_sizes(engine) as groups, request_split(torch, server, engine) as split:
        port = server.server_address[1]
        lstm_ops.launches = 0
        latencies = {}

        def client(item):
            t0 = time.perf_counter()
            code, reply, _ = http_request(port, '/predict', bodies[item['name']])
            latencies[item['name']] = time.perf_counter() - t0
            return code, reply

        start = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(N_UTTS) as pool:
            replies = list(pool.map(client, items))
        seconds = time.perf_counter() - start
        stats = http_request(port, '/stats')[1]
        k1 = lstm_ops.launches
    worst = 0.0
    for item, (code, reply) in zip(items, replies):
        if code != 200:
            raise AssertionError(f"http concurrent {item['name']}: {code} {reply}")
        worst = max(worst, hold_reply('http concurrent', reply['results'][item['name']],
                                      direct[item['name']]))
    dispatch = stats['dynamic_batching']
    if k1 != 8 * len(groups) or dispatch['requests_coalesced'] != N_UTTS:
        raise AssertionError(f'http concurrent: K1 launched {k1} times for {len(groups)} groups, '
                             f'{dispatch}')
    launches['k1'] += k1
    out['concurrent'] = {
        'clients': N_UTTS, 'seconds': seconds, 'utterances_per_s': N_UTTS / seconds,
        'frames_per_s': frames / seconds, 'latency_ms': stats['latency_ms'],
        'client_latency_ms': percentiles([v * 1e3 for v in latencies.values()]),
        'dispatch_groups': dispatch['dispatch_groups'],
        'requests_coalesced': dispatch['requests_coalesced'],
        'group_rows': [g for g, _ in groups], 'mean_group': float(np.mean([g for g, _ in groups])),
        'padded_rows': sum(p for _, p in groups), 'k1_launches': k1, 'max_abs_err': worst,
        'split_seconds': split, 'reply_mb': sum(len(json.dumps(r[1])) for r in replies) / 2 ** 20}

    # A stream to audio on the longest utterance.
    longest = max(items, key=lambda it: int(it['n_frames'].reshape(-1)[0]))
    n_longest = int(longest['n_frames'].reshape(-1)[0])
    with running_server(engine, dynamic_batch_ms=HTTP_BATCH_MS) as server:
        import http.client

        lstm_ops.launches = 0
        conn = http.client.HTTPConnection('127.0.0.1', server.server_address[1],
                                          timeout=HTTP_TIMEOUT)
        start = time.perf_counter()
        conn.request('POST', '/stream', json.dumps({'item': json_item(longest), 'audio': True}),
                     {'Content-Type': 'application/json'})
        resp = conn.getresponse()
        lines, first = [], None
        for raw in iter(resp.readline, b''):
            if first is None:
                first = time.perf_counter() - start
            lines.append(json.loads(raw))
        seconds = time.perf_counter() - start
        conn.close()
        k1 = lstm_ops.launches
    pcm = np.concatenate([np.frombuffer(base64.b64decode(line['wav_int16_b64']), '<i2')
                          for line in lines if 'wav_int16_b64' in line])
    wav = np.concatenate([w for _, w in engine.stream_item_audio(dict(longest))])
    chunks = -(-n_longest // STREAM_CONFIG[0])
    want = np.clip(wav * 32767.0, -32768, 32767).astype('<i2')
    if resp.status != 200 or not lines[-1].get('done') or not np.array_equal(pcm, want) \
            or k1 != 8 * chunks:
        raise AssertionError(f'http stream: status {resp.status}, last line {lines[-1]}, '
                             f'{pcm.shape} samples against {want.shape}, K1 {k1} for {chunks} '
                             'chunks')
    launches['k1'] += k1
    out['stream'] = {'utterance': longest['name'], 'frames': n_longest, 'chunks': chunks,
                     'lines': len(lines), 'samples': int(pcm.shape[0]),
                     'time_to_first_line_ms': first * 1e3, 'seconds': seconds,
                     'real_time_factor': pcm.shape[0] / FS / seconds, 'k1_launches': k1,
                     'samples_equal_stream_item_audio': True}

    # Hot reload under load.
    old_stream = [c for c in engine.stream_item(dict(longest))]
    gate, paused, stop = threading.Event(), threading.Event(), threading.Event()
    push = StreamingSynthesizer.push_world_feats
    pushes = [0]

    def gated_push(self, *args):
        pushes[0] += 1
        if pushes[0] == 2:   # the stream's second chunk waits for the reload
            paused.set()
            gate.wait(HTTP_TIMEOUT)
        return push(self, *args)

    path2 = os.path.join(http_root, 'epoch_2.npz')
    posted, errors, stream_lines = [], [], []
    raw_bodies = [json.dumps(bodies[item['name']]).encode() for item in items]
    with running_server(engine, dynamic_batch_ms=HTTP_BATCH_MS,
                        watch_checkpoints=RELOAD_WATCH) as server, \
            timed_calls(torch, engine, ('reload_checkpoint',)) as reload_s:
        port = server.server_address[1]
        lstm_ops.launches = 0

        def poster(i):
            k = i
            while not stop.is_set():
                code, reply = post_bytes(port, '/predict', raw_bodies[k % N_UTTS])
                posted.append(code)
                if code != 200:
                    errors.append((items[k % N_UTTS]['name'], code, reply[:200]))
                k += RELOAD_CLIENTS

        def streamer():
            import http.client
            conn = http.client.HTTPConnection('127.0.0.1', port, timeout=HTTP_TIMEOUT)
            conn.request('POST', '/stream', json.dumps({'item': json_item(longest),
                                                        'audio': True}),
                         {'Content-Type': 'application/json'})
            resp = conn.getresponse()
            stream_lines.extend(json.loads(raw) for raw in iter(resp.readline, b''))
            conn.close()

        StreamingSynthesizer.push_world_feats = gated_push
        threads = [threading.Thread(target=poster, args=(i,)) for i in range(RELOAD_CLIENTS)]
        threads.append(threading.Thread(target=streamer))
        try:
            for t in threads:
                t.start()
            if not paused.wait(HTTP_TIMEOUT):
                raise AssertionError('http reload: the stream never reached its second chunk')
            seeded_checkpoint(torch, LSTMAcousticModel, path2, 7)   # written atomically
            written = time.perf_counter()
            switch = None
            while time.perf_counter() - written < HTTP_TIMEOUT:
                if http_request(port, '/healthz')[1]['checkpoint'] == path2:
                    switch = time.perf_counter() - written
                    break
                time.sleep(0.02)
            gate.set()
            posted_at_switch = len(posted)
            while len(posted) < posted_at_switch + 2 * RELOAD_CLIENTS:
                time.sleep(0.05)
        finally:
            gate.set()
            stop.set()
            for t in threads:
                t.join(timeout=HTTP_TIMEOUT)
            StreamingSynthesizer.push_world_feats = push
        if switch is None or switch > RELOAD_DEADLINE or errors:
            raise AssertionError(f'http reload: /healthz switched after {switch} s '
                                 f'(limit {RELOAD_DEADLINE}), errors {errors[:3]}')
        after = {item['name']: http_request(port, '/predict', bodies[item['name']])[1]
                 for item in items[:RELOAD_CLIENTS]}
        k1 = lstm_ops.launches
    new_direct = engine.predict_items(items[:RELOAD_CLIENTS])
    worst = max(hold_reply('http after reload', after[name]['results'][name], new_direct[name])
                for name in after)
    moved = max(float(np.abs(new_direct[name]['vuv'] - direct[name]['vuv']).max())
                for name in after)
    streamed_chunks = [line['chunk'] for line in stream_lines
                       if line.get('chunk') and len(next(iter(line['chunk'].values())))]
    new_stream = list(engine.stream_item(dict(longest)))

    def stream_err(chunks):
        if [len(c['lf0']) for c in chunks] != [len(c['lf0']) for c in old_stream]:
            return math.inf
        return max(rel_max(np.asarray(got[key], want[key].dtype), want[key])
                   for got, want in zip(chunks, old_stream) for key in want)

    vs_old, new_vs_old = stream_err(streamed_chunks), stream_err(new_stream)
    if not stream_lines[-1].get('done') or vs_old > STREAM_PIN_RTOL \
            or not new_vs_old > 100 * STREAM_PIN_RTOL or moved == 0.0:
        raise AssertionError(f'http reload: the stream started before the switch is '
                             f"{vs_old} from the old weights' stream frame for frame, the new "
                             f"weights' stream {new_vs_old}; replies moved by {moved}")
    launches['k1'] += k1
    out['hot_reload'] = {'clients': RELOAD_CLIENTS, 'watch_s': RELOAD_WATCH,
                         'switch_s': switch, 'reload_build_s': reload_s['reload_checkpoint'][0],
                         'requests': len(posted), 'errors': len(errors),
                         'max_abs_err_after': worst, 'vuv_moved_by': moved,
                         'stream_chunks': len(streamed_chunks), 'stream_vs_old_weights': vs_old,
                         'new_weights_stream_vs_old': new_vs_old, 'k1_launches': k1}

    # A fleet of three voices.
    f0_ckpt = seeded_checkpoint(torch, F0Model, os.path.join(http_root, 'f0', 'epoch_1.npz'), 20)
    tf_ckpt = seeded_checkpoint(torch, TransformerAcousticModel,
                                os.path.join(http_root, 'transformer', 'epoch_1.npz'), 40)
    fleet = {'lstm': engine,
             'f0': InferenceEngine(F0Model, f0_ckpt, data_root=root, batch_size=SERVE_BATCH),
             'transformer': InferenceEngine(TransformerAcousticModel, tf_ckpt, data_root=root,
                                            batch_size=SERVE_BATCH)}
    f0_item = f0_items(np.random.default_rng(20))[1]
    voice_items = {'lstm': items[1], 'f0': f0_item, 'transformer': items[1]}
    expect = {'lstm': (8, 0, 0), 'f0': (0, 3, 0), 'transformer': (0, 0, 6)}
    fleet_out = {}
    with running_server(fleet, dynamic_batch_ms=HTTP_BATCH_MS) as server:
        port = server.server_address[1]
        for voice, item in voice_items.items():
            fleet[voice].predict_items([item])     # warm-up, not counted
            lstm_ops.launches = gru_ops.launches = fa.launches = 0
            start = time.perf_counter()
            code, reply, _ = http_request(port, '/predict', {'items': [json_item(item)],
                                                             'model': voice})
            seconds = time.perf_counter() - start
            counts = (lstm_ops.launches, gru_ops.launches, fa.launches)
            if code != 200 or counts != expect[voice]:
                raise AssertionError(f'http fleet {voice}: {code}, launches (K1, K3, attention) '
                                     f'{counts}, expected {expect[voice]}')
            err = hold_reply(f'http fleet {voice}', reply['results'][item['name']],
                             fleet[voice].predict_items([item])[item['name']])
            for kind, n in zip(('k1', 'k3', 'attn'), counts):
                launches[kind] += n
            fleet_out[voice] = {'seconds': seconds, 'k1_k3_attn_launches': counts,
                                'max_abs_err': err}
        code, reply, _ = http_request(port, '/predict', {'items': [json_item(items[1])],
                                                         'model': 'nope'})
        health = http_request(port, '/healthz')[1]
    if code != 404 or sorted(health['models']) != sorted(fleet):
        raise AssertionError(f'http fleet: unknown voice answered {code}, /healthz {health}')
    out['fleet'] = dict(fleet_out, unknown_voice=code)
    out['launches'] = launches
    emit(out)
    return launches


def quantize_serve_phase(torch, served, smi):
    """The full-width LSTMAcousticModel engine with quantize='int8' and
    'int4' on the 32 utterances at B16: each held to the CPU engine in the
    same mode on the 4 shortest (QUANT_RTOL relative L2: both dequantise the
    same q * scale); the relative L2 of each output against the f32 engine
    (recorded beside JAX's bounds at its test sizes, not held); the device
    bytes of the model, from torch.cuda.memory_allocated around the build,
    against the f32 engine's (held to QUANT_BYTES_BOUND), and that a call
    leaves nothing resident; frames/s and K1 launches (8 a batch, the f32
    build). Then python -m morgana_tpu_torch.quantize --bits 8 on the
    checkpoint: an engine on its output, without the flag, serves
    quantized, bit-identical to the quantize='int8' engine. Returns K1's
    launches."""
    import gc

    from morgana_tpu_torch import quantize
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.serve import InferenceEngine

    root, items = served['root'], served['items']
    few = sorted(items, key=lambda it: int(it['n_frames'].reshape(-1)[0]))[:4]
    frames = sum(int(item['n_frames'].reshape(-1)[0]) for item in items)
    n_batches = -(-N_UTTS // SERVE_BATCH)

    def build(ckpt, mode):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        engine = InferenceEngine(LSTMAcousticModel, ckpt, data_root=root,
                                 batch_size=SERVE_BATCH, quantize=mode)
        torch.cuda.synchronize()
        return engine, torch.cuda.memory_allocated() - before

    f32, f32_bytes = build(served['ckpt'], None)
    f32.predict_items(items[:2])     # warm-up: this thread's cuBLAS workspace
    f32_params = dict(f32.model.named_parameters())
    out = {'phase': 'quantize_serve', 'card': smi, 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
           'utterances': N_UTTS, 'frames': frames, 'batch_size': SERVE_BATCH,
           'f32_model_bytes': f32_bytes, 'cpu_rtol': QUANT_RTOL,
           'jax_float_bounds_at_test_sizes': JAX_QUANT_BOUND, 'modes': {}}
    launches = 0
    engines = {}
    for mode in ('int8', 'int4'):
        engine, model_bytes = build(served['ckpt'], mode)
        engines[mode] = engine
        held = dict(engine.model.named_parameters())
        q_bytes = sum(p.numel() * p.element_size() for n, p in held.items()
                      if '.parametrizations.' in n)
        matrices = [f32_params[n.replace('.parametrizations.', '.').rsplit('.', 1)[0]]
                    for n in held if n.endswith('.original0')]
        f32_matrix_bytes = sum(4 * p.numel() for p in matrices)
        resident = torch.cuda.memory_allocated()
        lstm_ops.launches = lstm_ops.bf16_launches = 0
        start = time.perf_counter()
        outputs = engine.predict_items(items)
        seconds = time.perf_counter() - start
        k1, k1_bf16 = lstm_ops.launches, lstm_ops.bf16_launches
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - resident
        smallest = min(4 * p.numel() for p in matrices)
        cpu = InferenceEngine(LSTMAcousticModel, served['ckpt'], data_root=root, device='cpu',
                              batch_size=SERVE_BATCH, quantize=mode).predict_items(few)
        vs_cpu = {key: max(rel_l2(outputs[it['name']][key], cpu[it['name']][key]) for it in few)
                  for key in ACOUSTIC_DIMS}
        vs_f32 = {key: max(rel_l2(outputs[it['name']][key], served['outputs'][it['name']][key])
                           for it in items) for key in ACOUSTIC_DIMS}
        ratio = model_bytes / f32_bytes
        if not engine.quantized or k1 != 8 * n_batches or k1_bf16 \
                or max(vs_cpu.values()) > QUANT_RTOL or ratio > QUANT_BYTES_BOUND[mode] \
                or left >= smallest or not all(
                    np.isfinite(outputs[it['name']][k]).all() for it in items for k in ACOUSTIC_DIMS):
            raise AssertionError(f'quantize_serve {mode}: K1 {k1} ({k1_bf16} bf16), vs CPU '
                                 f'{vs_cpu}, bytes {ratio} of f32, {left} bytes left after a call')
        launches += k1
        out['modes'][mode] = {
            'model_bytes': model_bytes, 'bytes_vs_f32': ratio,
            'bytes_bound': QUANT_BYTES_BOUND[mode], 'quantized_matrix_bytes': q_bytes,
            'quantized_matrix_bytes_vs_f32': q_bytes / f32_matrix_bytes,
            'resident_after_call_bytes': left, 'seconds': seconds,
            'utterances_per_s': N_UTTS / seconds, 'frames_per_s': frames / seconds,
            'k1_launches': k1, 'rel_l2_vs_cpu': vs_cpu, 'rel_l2_vs_f32': vs_f32}

    qdir = os.path.join(root, 'quantized')
    os.makedirs(qdir)
    qpath = os.path.join(qdir, 'epoch_1_q8.npz')
    proc = subprocess.run([sys.executable, '-m', 'morgana_tpu_torch.quantize', '--checkpoint',
                           served['ckpt'], '--out', qpath, '--bits', '8'],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f'quantize CLI failed: {proc.stderr[-2000:]}')
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    detected = InferenceEngine(LSTMAcousticModel, qpath, data_root=root, batch_size=SERVE_BATCH)
    lstm_ops.launches = 0
    got = detected.predict_items(items)
    want = engines['int8'].predict_items(items)
    launches += lstm_ops.launches
    same = all(np.array_equal(got[it['name']][k], want[it['name']][k])
               for it in items for k in ACOUSTIC_DIMS)
    if not quantize.is_quantized_checkpoint(qpath) or not detected.quantized or not same:
        raise AssertionError(f'quantize CLI: {qpath} detected {detected.quantized}, outputs equal '
                             f'to the int8 engine {same}')
    out['cli'] = dict(cli, detected=True, bit_identical_to_int8_engine=True)
    out['k1_launches'] = launches
    emit(out)
    return launches


EXPORT_RUN = r'''
import json, sys, time
start = time.perf_counter()
import numpy as np
import torch
from morgana_tpu_torch.export import ExportedVoice
from morgana_tpu_torch.ops import flash_attention, gru, lstm, mlpg

COUNTERS = {'k1': lstm, 'k3': gru, 'attn_fwd': flash_attention, 'mlpg_solve': mlpg}
BF16 = {'k1c': (lstm, 'bf16_compute_launches'), 'k3c': (gru, 'bf16_compute_launches'),
        'k5b': (flash_attention, 'bf16_launches'),
        'k1c_cluster': (lstm, 'bf16_cluster_launches')}
report = {'voices': {}}
for spec in json.loads(sys.argv[1]):
    before = {k: m.launches for k, m in COUNTERS.items()}
    before_bf16 = {k: getattr(m, a) for k, (m, a) in BF16.items()}
    before_fused = mlpg.fused_launches
    t0 = time.perf_counter()
    voice = ExportedVoice(spec['dir'])
    with np.load(spec['batches']) as data:
        batches = {}
        for key in data.files:
            i, name = key.split('__', 1)
            batches.setdefault(int(i), {})[name] = data[key]
    outs, run_ms = {}, []
    for i in sorted(batches):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        staged, out = voice.run(batches[i])
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            first_ms = (time.perf_counter() - t0) * 1e3
        outs.update({f'{i}__{k}': v.cpu().numpy() for k, v in out.items()})
    launches = {k: m.launches - before[k] for k, m in COUNTERS.items()}
    launches.update({k: getattr(m, a) - before_bf16[k] for k, (m, a) in BF16.items()})
    launches['mlpg'] = mlpg.fused_launches - before_fused
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    voice.run(batches[0])
    torch.cuda.synchronize()
    np.savez(spec['out'], **outs)
    report['voices'][spec['name']] = {
        'first_call_ms': first_ms, 'run_ms': run_ms,
        'again_ms': (time.perf_counter() - t1) * 1e3, 'launches': launches, 'staged': staged}
report['models_imported'] = sorted(m for m in sys.modules if '.models' in m)
report['jax_imported'] = any(m == 'jax' or m.startswith('morgana_tpu.') for m in sys.modules)
report['process_s'] = time.perf_counter() - start
print(json.dumps(report))
'''

ENGINE_FIRST = r'''
import json, sys, time
start = time.perf_counter()
import numpy as np
import torch
from morgana_tpu_torch.serve import InferenceEngine, load_model_class
spec, ckpt, root, batch_file = sys.argv[1:]
t0 = time.perf_counter()
engine = InferenceEngine(load_model_class(spec), ckpt, data_root=root, batch_size=16)
with np.load(batch_file) as data:
    batch = {k.split('__', 1)[1]: data[k] for k in data.files if k.startswith('0__')}
out = engine.predict_batch(batch)
torch.cuda.synchronize()
first_ms = (time.perf_counter() - t0) * 1e3
torch.cuda.synchronize()
t1 = time.perf_counter()
engine.predict_batch(batch)
torch.cuda.synchronize()
print(json.dumps({'first_call_ms': first_ms, 'again_ms': (time.perf_counter() - t1) * 1e3,
                  'process_s': time.perf_counter() - start}))
'''


def run_script(label, script, *argv, timeout=600):
    """Runs `script` with `argv` in a fresh Python process from the repo
    root; its last stdout line, parsed as JSON."""
    proc = subprocess.run([sys.executable, '-c', script, *argv], capture_output=True, text=True,
                          timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f'{label}: exited {proc.returncode}\n{proc.stderr[-4000:]}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def export_voice(torch, name, model_class, ckpt, root, items, spec, out_dir):
    """Exports `items` (written as a split of `root`) through an engine of
    `model_class` at B16 with export_bundle; returns the bundle's numbers
    and what the subprocess needs: the batches and the engine's outputs on
    them, as .npz files beside the bundle."""
    from morgana_tpu_torch.export import export_bundle
    from morgana_tpu_torch.serve import InferenceEngine, numeric_features

    engine = InferenceEngine(model_class, ckpt, data_root=root, batch_size=SERVE_BATCH)
    id_list = write_items(root, f'export_{name}', items, engine.model.test_data_sources())
    engine.predict_items(items[:2])            # warm-up, as the serving phases
    torch.cuda.synchronize()
    start = time.perf_counter()
    manifest = export_bundle(engine, out_dir, data_dir=f'export_{name}', id_list=id_list,
                             model_spec=spec)
    export_s = time.perf_counter() - start
    batches, want = {}, {}
    for i, features in enumerate(engine._loader(f'export_{name}', id_list=id_list)):
        batches.update({f'{i}__{k}': v for k, v in
                        numeric_features(host_features(features)).items()})
        want.update({f'{i}__{k}': v.cpu().numpy()
                     for k, v in engine.predict_batch(features).items()})
    np.savez(out_dir + '.batches.npz', **batches)
    files = {f: os.path.getsize(os.path.join(out_dir, f)) for f in os.listdir(out_dir)}
    return {'name': name, 'dir': out_dir, 'batches': out_dir + '.batches.npz',
            'out': out_dir + '.out.npz'}, want, {
        'export_s': export_s, 'programs': [(p['batch'], p['max_frames'])
                                           for p in manifest['programs']],
        'program_bytes': sum(v for f, v in files.items() if f.endswith('.pt2')),
        'params_bytes': files['params.npz'], 'batches': len({k.split('__')[0] for k in want})}


def export_phase(torch, served, smi):
    """The deployment bundle on the card: LSTMAcousticModel at full width
    (the serving phase's checkpoint) at B16 over the 32 utterances, one
    program a bucket, and one bucket each of seeded TransformerAcousticModel
    (K5) and F0Model (K3) voices. A fresh process that imports no model
    module (nor JAX) runs the bundles with ExportedVoice: its outputs equal
    the engine's within EXPORT_RTOL, and its launch counters show K1, K3,
    the attention forward and the MLPG solve inside the loaded programs.
    Export seconds, bytes, and the first-call latency of a fresh process,
    the bundle's against the engine's. Returns the subprocess's launches."""
    from morgana_tpu_torch.models.f0_test_model import F0Model
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel

    base = os.path.join(served['root'], 'export')
    os.makedirs(base)
    specs, wants, numbers = [], {}, {}
    lstm_spec = 'morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel'
    voices = [('lstm', LSTMAcousticModel, served['ckpt'], served['root'], served['items'],
               lstm_spec)]
    for name, cls, make, seed in (('transformer', TransformerAcousticModel, make_items, 61),
                                  ('f0', F0Model, f0_items, 62)):
        root = os.path.join(base, f'{name}_voice')
        os.makedirs(root)
        rng = np.random.default_rng(seed)
        ckpt = seeded_checkpoint(torch, cls, os.path.join(root, 'epoch_1.npz'), seed)
        write_normalisers(root, rng)
        voices.append((name, cls, ckpt, root, make(rng)[:SERVE_BATCH],
                       f'{cls.__module__}:{cls.__name__}'))
    for name, cls, ckpt, root, items, spec in voices:
        entry, wants[name], numbers[name] = export_voice(
            torch, name, cls, ckpt, root, items, spec, os.path.join(base, name))
        specs.append(entry)

    report = run_script('export: ExportedVoice', EXPORT_RUN, json.dumps(specs))
    if report['models_imported'] or report['jax_imported']:
        raise AssertionError(f'export: the bundle process imported {report["models_imported"]} '
                             f'(JAX: {report["jax_imported"]})')
    layers = {'lstm': ('k1', 8), 'transformer': ('attn_fwd', TRANSFORMER_BLOCKS),
              'f0': ('k3', F0_LAYERS)}
    for spec in specs:
        name, got = spec['name'], report['voices'][spec['name']]
        kernel, per_batch = layers[name]
        n = numbers[name]['batches']
        if (got['launches'][kernel] != per_batch * n or got['launches']['mlpg_solve'] != n
                or got['launches']['mlpg'] != n):
            raise AssertionError(f'export {name}: launches {got["launches"]} for {n} batches')
        errs = {}
        with np.load(spec['out']) as out:
            if sorted(out.files) != sorted(wants[name]):
                raise AssertionError(f'export {name}: outputs {sorted(out.files)}')
            for key, want in wants[name].items():
                errs[key] = float(np.abs(out[key] - want).max()) / max(
                    float(np.abs(want).max()), 1e-30)
        worst = max(errs.values())
        if worst > EXPORT_RTOL:
            raise AssertionError(f'export {name}: {worst} from the engine (bar {EXPORT_RTOL})')
        numbers[name].update(bundle=got, max_rel_err_vs_engine=worst)
    engine_first = run_script('export: engine first call', ENGINE_FIRST, lstm_spec,
                              served['ckpt'], served['root'], specs[0]['batches'])
    emit({'phase': 'export', 'card': smi, 'batch_size': SERVE_BATCH, 'rtol': EXPORT_RTOL,
          'voices': numbers, 'bundle_process_s': report['process_s'],
          'lstm_engine_fresh_process': engine_first})
    return {kernel: sum(report['voices'][name]['launches'][kernel] for name in numbers)
            for kernel in ('k1', 'k3', 'attn_fwd', 'mlpg_solve', 'mlpg')}


CACHE_RUN = r'''
import json, sys, time
start = time.perf_counter()
from morgana_tpu_torch import _build, serve
from morgana_tpu_torch.ops import lstm, mlpg
serve.main(sys.argv[1:])
print(json.dumps({'nvcc_runs': _build.nvcc_runs, 'cxx_runs': _build.cxx_runs,
                  'build_dir': _build.BUILD_DIR, 'k1': lstm.launches,
                  'mlpg_solve': mlpg.launches, 'seconds': time.perf_counter() - start}))
'''


def compilation_cache_phase(torch, served, smi):
    """--compilation_cache_dir: the serving command line (generation of the
    2 shortest served utterances) twice, each a fresh process, pointed at a
    new directory. The first builds the kernels its path loads (K1, the
    MLPG solve), the vocoder's library and the native batch reader's there;
    the second finds them and runs no compiler. Both launch the kernels and
    write the wavs."""
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel

    root = served['root']
    few = sorted(served['items'], key=lambda it: int(it['n_frames'].reshape(-1)[0]))[:2]
    with torch.device('meta'):
        sources = LSTMAcousticModel().test_data_sources()
    id_list = write_items(root, 'cache', few, sources)
    cache = os.path.join(root, 'kernel_cache')
    runs = []
    for i in range(2):
        runs.append(run_script(f'compilation_cache run {i}', CACHE_RUN, '--model',
                               'morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel',
                               '--checkpoint_path', served['ckpt'], '--data_root', root,
                               '--data_dir', 'cache', '--id_list', id_list, '--out_dir',
                               os.path.join(root, f'cache_gen{i}'), '--batch_size',
                               str(SERVE_BATCH), '--compilation_cache_dir', cache))
        wavs = os.listdir(os.path.join(root, f'cache_gen{i}', 'synth'))
        if len(wavs) != len(few) or runs[-1]['k1'] != 8 or runs[-1]['mlpg_solve'] != 1:
            raise AssertionError(f'compilation_cache run {i}: {runs[-1]}, wavs {wavs}')
    if runs[0]['nvcc_runs'] != 2 or runs[0]['cxx_runs'] != 2 \
            or runs[1]['nvcc_runs'] or runs[1]['cxx_runs']:
        raise AssertionError(f'compilation_cache: compilers run {runs}')
    emit({'phase': 'compilation_cache', 'card': smi, 'dir_files': sorted(os.listdir(cache)),
          'runs': runs})


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def rel_max(a, b):
    """max |a - b| over max(1, max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max()))) if b.size else 0.0


# ------------------------------------------------------------------ bf16

# K5b rounds the unnormalised probabilities of its online softmax where its
# plain version (the exact path) rounds the normalised ones: an independent
# rounding of the same size. So K5b is held to be closer in mean |error| to
# its bf16 plain version than to the f32 one by K5B_CLOSER (1), not by
# BF16_CLOSER (K1c and K3c round where their plain versions do).
K5B_CLOSER = 1

# K5b's o is also held to K5B_O_OF_CONTROL times the largest |error| of its
# control, the plain version in f32 on the same bf16 q, k and v (no rounding
# of p): the plain version's own rounding of p. K5b's error is two such
# roundings (its unnormalised p and the plain version's normalised p). Sound
# runs on the H100 gave ratios of 0.98-1.17 at k5b_case's shapes (PERF.md
# §6), the CPU emulation up to 1.44 at the GPU tests' edge shapes; 2
# leaves room for the second rounding. Plus F32_SLACK of the largest |value|
# for the f32 sums alone (at T = 1 the control rounds nothing). Its lse,
# which K5b's backward reads, is held to the log-sum-exp of the plain logits
# within K5B_LSE_RTOL of max(1, |lse|), as tests/test_torch_kernels.py holds
# it.
K5B_O_OF_CONTROL = 2.0
F32_SLACK = 2.0 ** -20
K5B_LSE_RTOL = 1e-5


@contextlib.contextmanager
def compute_dtype(name):
    """The process's compute dtype (nn.set_default_compute_dtype) `name`
    inside, what it was after: engines read it at each call."""
    from morgana_tpu_torch import nn

    saved = nn.default_compute_dtype()
    nn.set_default_compute_dtype(name)
    try:
        yield
    finally:
        nn.set_default_compute_dtype(saved)


def attention_bf16_bound(batch, heads, time_steps, head_dim, pairs, rows):
    """Least time for K5b: 4 * P * dh flops (q.k and p.v) at the bf16
    tensor-core peak and P exp at the SFU rate, against bf16 q, k and v read
    on the `rows` rows below seq_len and f32 o and lse written on every row
    at the memory rate."""
    width = heads * head_dim
    ops_ms = max(4.0 * pairs * head_dim / BF16_PEAK_FLOPS, pairs / SFU_EXP_PER_S) * 1e3
    nbytes = 2.0 * 3 * rows * width + 4.0 * (batch * time_steps * width
                                             + batch * heads * time_steps)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def hold_bf16(label, got, want, f32, closer_by=BF16_CLOSER, common_scale=False, held=True):
    """The tensors `got` (a kernel's bf16-compute outputs) against `want`
    (its plain version's): each within bf16_tol (with `common_scale`, of the
    largest |value| of them all), and `closer_by` times closer in mean
    |error| to them than to `f32` (the f32 plain version's). Returns the
    numbers; with `held` False it only reports them, with 'held': False and
    'within_tolerance'."""
    err = max(max_abs(a.float() - b.float()) for a, b in zip(got, want))
    top = max(max_abs(b.float()) for b in want)
    within = all(max_abs(a.float() - b.float())
                 <= (BF16_ULPS * 2.0 ** -7 * top if common_scale else bf16_tol(b))
                 for a, b in zip(got, want))
    near, far = mean_abs_err(zip(got, want)), mean_abs_err(zip(got, f32))
    out = {'max_abs_err_vs_plain': err, 'mean_err_vs_plain': near, 'mean_err_vs_f32': far,
           'tolerance': f'{BF16_ULPS} bf16 ulps at each output\'s max, mean {closer_by}x '
                        'closer to the bf16 plain version than to the f32 one'}
    ok = within and far > 0 and near * closer_by <= far and (closer_by > 1 or near < far)
    if not held:
        out.update(held=False, within_tolerance=ok,
                   max_rel_err_vs_plain={i: max_abs(a.float() - b.float())
                                         / max(max_abs(b.float()), 1e-30)
                                         for i, (a, b) in enumerate(zip(got, want))})
    elif not ok:
        raise AssertionError(f'{label} disagrees with its plain version: {out}')
    return out


def k1c_case(torch, dev, batch, time_steps, with_state, seed, timed, hidden=H):
    """K1c (f32 storage, bf16 products: the scan backend under
    --compute_dtype bfloat16) through lstm_layer(compute_dtype='bfloat16')
    against lstm_layer_reference with the same compute dtype on the card
    (hold_bf16: y, hn, cn), one K1c launch and no other, on the route the
    width gives (the cluster kernel up to 512, the grid build at 1024). With
    `timed`, K1c alone, its plain version, the layer, cuDNN's LSTM in bf16
    (weights, input and state) and the bound."""
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.ops import precision

    x, (w_ih, w_hh, b_ih, b_hh), seq_len, h0, c0 = layer_inputs(
        torch, dev, batch, time_steps, with_state, seed, hidden)
    weights, state = (w_ih, w_hh, b_ih, b_hh), dict(seq_len=seq_len, h0=h0, c0=c0)
    route = lstm_ops.bf16_route(hidden)
    with torch.inference_mode():
        before = (lstm_ops.launches, lstm_ops.bf16_compute_launches,
                  lstm_ops.bf16_cluster_launches)
        y, (hn, cn) = lstm_ops.lstm_layer(x, *weights, compute_dtype='bfloat16', **state)
        torch.cuda.synchronize()
        launched = (lstm_ops.launches - before[0], lstm_ops.bf16_compute_launches - before[1],
                    lstm_ops.bf16_cluster_launches - before[2])
        wy, (wh, wc) = lstm_ops.lstm_layer_reference(x, *weights, compute_dtype='bfloat16',
                                                     **state)
        fy, (fh, fc) = lstm_ops.lstm_layer_reference(x, *weights, **state)
        out = {'phase': 'k1c', 'route': route, 'B': batch, 'T': time_steps, 'H': hidden,
               'initial_state': with_state, 'launches': launched[0], 'k1c_launches': launched[1],
               'cluster_launches': launched[2],
               **hold_bf16(f'K1c B={batch} T={time_steps} H={hidden}', [y, hn, cn],
                           [wy, wh, wc], [fy, fh, fc])}
        if route == 'cluster':
            out['plan_tiles_clusters_fit'] = lstm_ops.cluster_plan(batch, hidden)
        if timed:
            xg = (precision.matmul(x, w_ih, torch.bfloat16) + (b_ih + b_hh)).transpose(0, 1) \
                .contiguous()
            zeros = torch.zeros((batch, hidden), device=dev)
            hs, cs = (zeros, zeros) if h0 is None else (h0, c0)
            out['kernel_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_recurrence(
                xg, w_hh, hs, cs, compute_bf16=True), 10)
            out['plain_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_recurrence_reference(
                xg, w_hh, hs, cs, compute_bf16=True), 2)
            out['layer_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_layer(
                x, *weights, compute_dtype='bfloat16', **state), 10)
            cudnn = cudnn_in(cudnn_layer(torch, dev, *weights), torch.bfloat16)
            x_l = x.to(torch.bfloat16)
            hx = None if h0 is None else (h0[None].bfloat16(), c0[None].bfloat16())
            out['library_ms'] = cuda_ms(torch, lambda: cudnn(x_l, hx), 20)
            out['bound_ms'], out['bound_by'] = k1_bound(batch, time_steps, hidden,
                                                        compute='bfloat16')
            out['us_per_step'] = out['kernel_ms'] * 1e3 / time_steps
    emit(out)
    if launched != (1, 1, int(route == 'cluster')):
        raise AssertionError(f'K1c: launches {launched}, expected one K1c launch on the '
                             f'{route} route')
    return out


def k3c_case(torch, dev, batch, time_steps, hidden, in_dim, with_state, seed, timed):
    """K3c (the GRU recurrence with bf16 products) through
    gru_layer(compute_dtype='bfloat16') against gru_layer_reference with the
    same compute dtype (hold_bf16: y, hn), one K3c launch; with `timed`, K3c
    alone as the layer launches it, its plain version, the layer, cuDNN's
    GRU in bf16 and the bound."""
    from morgana_tpu_torch.ops import gru as gru_ops
    from morgana_tpu_torch.ops import precision

    x, (w_ih, w_hh, b_ih, b_hh), seq_len, h0 = gru_inputs(
        torch, dev, batch, time_steps, hidden, in_dim, with_state, seed)
    args = (x, w_ih, w_hh, b_ih, b_hh, seq_len, h0)
    with torch.inference_mode():
        before = (gru_ops.launches, gru_ops.bf16_compute_launches)
        y, hn = gru_ops.gru_layer(*args, compute_dtype='bfloat16')
        torch.cuda.synchronize()
        launched = (gru_ops.launches - before[0], gru_ops.bf16_compute_launches - before[1])
        wy, wh = gru_ops.gru_layer_reference(*args, compute_dtype='bfloat16')
        fy, fh = gru_ops.gru_layer_reference(*args)
        out = {'phase': 'k3c', 'B': batch, 'T': time_steps, 'H': hidden, 'in_dim': in_dim,
               'initial_state': with_state, 'launches': launched[0], 'k3c_launches': launched[1],
               **hold_bf16(f'K3c B={batch} T={time_steps} H={hidden}', [y, hn], [wy, wh],
                           [fy, fh])}
        if timed:
            xg = precision.matmul(x, w_ih, torch.bfloat16) + b_ih
            xg_t = xg.transpose(0, 1).contiguous()
            hs = torch.zeros((batch, hidden), device=dev) if h0 is None else h0
            out['kernel_ms'] = cuda_ms(torch, lambda: gru_ops._gru_fwd_cuda(
                xg, w_hh, b_hh, hs, seq_len, compute_bf16=True), 50)
            out['plain_ms'] = cuda_ms(torch, lambda: gru_ops.gru_recurrence_reference(
                xg_t, w_hh, b_hh, hs, compute_bf16=True), 2)
            out['layer_ms'] = cuda_ms(torch, lambda: gru_ops.gru_layer(
                *args, compute_dtype='bfloat16'), 50)
            cudnn = cudnn_in(cudnn_gru(torch, dev, w_ih, w_hh, b_ih, b_hh), torch.bfloat16)
            x_l = x.to(torch.bfloat16)
            hx = None if h0 is None else h0[None].bfloat16()
            out['library_ms'] = cuda_ms(torch, lambda: cudnn(x_l, hx), 50)
            out['bound_ms'], out['bound_by'] = k3_bound(batch, time_steps, hidden, 'bfloat16')
            out['us_per_step'] = out['kernel_ms'] * 1e3 / time_steps
    emit(out)
    if launched != (1, 1):
        raise AssertionError(f'K3c: launches {launched}, expected one K3c launch')
    return out


def k5b_case(torch, dev, batch, heads, time_steps, head_dim, causal, window, seed, timed,
             empty_row=False):
    """K5b (the attention forward on bf16 q, k and v) through
    flash_attention(compute_dtype=bf16) against the plain bf16 attention on
    the rows below seq_len (hold_bf16 with K5B_CLOSER, and within
    K5B_O_OF_CONTROL times the control's largest |error|); o in f32, rows
    that see no key 0, one K5b launch. Then K5b alone (attention_forward):
    its o the same bits, its lse within K5B_LSE_RTOL of the log-sum-exp of
    the plain logits on the rows below seq_len, +inf on the empty row. With
    `timed`, K5b alone (CUDA events over 20 calls of the wrapper, and its
    kernel's device ms by the profiler), its plain version and torch's SDPA
    on the same bf16 q, k and v (both by events and by the profiler's device
    time), the host time of the wrapper's three tensor-map encodes, and the
    bound."""
    from morgana_tpu_torch.ops import flash_attention as fa

    q, k, v, seq_len = attention_inputs(torch, dev, batch, heads, time_steps, head_dim, seed,
                                        empty_row)
    mask = dict(seq_len=seq_len, causal=causal, window=window)
    with torch.inference_mode():
        before = (fa.launches, fa.bf16_launches)
        got = fa.flash_attention(q, k, v, compute_dtype=torch.bfloat16, **mask)
        torch.cuda.synchronize()
        launched = (fa.launches - before[0], fa.bf16_launches - before[1])
        want = fa.flash_attention_reference(q, k, v, compute_dtype=torch.bfloat16, **mask)
        f32 = fa.flash_attention_reference(q, k, v, **mask)
        valid = valid_rows(torch, seq_len, time_steps)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        control = fa.flash_attention_reference(qb.float(), kb.float(), vb.float(), **mask)
        o_alone, lse = fa.attention_forward(qb, kb, vb, **mask)
        bias = fa.attention_bias(seq_len, time_steps, causal, window, device=dev)
        logits = torch.matmul(qb.float(), kb.float().transpose(-1, -2)) / head_dim ** 0.5
        want_lse = torch.logsumexp(logits if bias is None else logits + bias, -1)
        del logits
        rows = valid[..., 0].expand_as(lse)
        lse_err = max_abs(torch.where(rows, lse - want_lse, 0.))
        lse_tol = K5B_LSE_RTOL * max(1.0, max_abs(want_lse[rows]))
        o_err, control_err = max_abs((got - want) * valid), max_abs((control - want) * valid)
        pairs = attention_pairs(seq_len.tolist(), time_steps, heads, causal, window)
        out = {'phase': 'k5b', 'B': batch, 'H': heads, 'T': time_steps, 'dh': head_dim,
               'causal': causal, 'window': window, 'seq_len_min': int(seq_len.min()),
               'visible_pairs': pairs, 'o_dtype': str(got.dtype).replace('torch.', ''),
               'finite': bool(torch.isfinite(got).all()),
               'empty_row_zero': not empty_row or bool((got[-1] == 0).all()),
               'launches': launched[0], 'k5b_launches': launched[1],
               'control_max_abs_err': control_err,
               'o_tolerance': (K5B_O_OF_CONTROL * control_err
                               + F32_SLACK * max_abs(want * valid)),
               'o_err_of_control': o_err / control_err if control_err else None,
               'alone_same_o': bool(torch.equal(o_alone, got)),
               'lse_max_abs_err': lse_err, 'lse_tolerance': lse_tol,
               'empty_row_lse_inf': not empty_row or bool(torch.isinf(lse[-1]).all()),
               **hold_bf16(f'K5b B={batch} T={time_steps} dh={head_dim}', [got * valid],
                           [want * valid], [f32 * valid], K5B_CLOSER)}
        if timed:
            def plain():
                return fa.flash_attention_reference(q, k, v, compute_dtype=torch.bfloat16, **mask)

            def library():
                return sdpa(torch, qb, kb, vb, **mask)

            out['kernel_ms'] = cuda_ms(torch, lambda: fa.attention_forward(qb, kb, vb, **mask), 20)
            out['device_ms'] = kernel_device_ms(
                torch, lambda: fa.attention_forward(qb, kb, vb, **mask), 20,
                'attn_fwd_bf16_kernel')[0]
            out['plain_ms'] = cuda_ms(torch, plain, 5)
            out['plain_device_ms'] = call_device_ms(torch, plain, 5)
            out['library_ms'] = cuda_ms(torch, library, 20)
            out['library_device_ms'] = call_device_ms(torch, library, 20)
            out['tensor_map_encode_us'] = tensor_map_encode_us(qb)
            out['bound_ms'], out['bound_by'] = attention_bf16_bound(
                batch, heads, time_steps, head_dim, pairs,
                attention_rows(seq_len.tolist(), time_steps))
    emit(out)
    if not (launched == (1, 1) and out['finite'] and out['empty_row_zero']
            and got.dtype == torch.float32 and o_err <= out['o_tolerance']
            and out['alone_same_o'] and lse_err <= lse_tol and out['empty_row_lse_inf']):
        raise AssertionError(f'K5b: {out}')
    return out


def tensor_map_encode_us(q, reps=2000):
    """Host microseconds of the three cuTensorMapEncodeTiled calls that K5b's
    wrapper makes at each launch (attn_fwd_bf16.cu's tile_map: a bf16 (B * H,
    T, dh) map, 64 x 128 x 1 boxes, 128-byte swizzle), at q's shape, called
    from libcuda.so.1 through ctypes (whose own cost, a few tenths of a
    microsecond a call, is in the number)."""
    import ctypes

    encode = ctypes.CDLL('libcuda.so.1').cuTensorMapEncodeTiled
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    encode.argtypes = [ctypes.c_void_p, ctypes.c_int, u32, ctypes.c_void_p,
                       ctypes.POINTER(u64), ctypes.POINTER(u64), ctypes.POINTER(u32),
                       ctypes.POINTER(u32)] + [ctypes.c_int] * 4
    encode.restype = ctypes.c_int
    batch, heads, time_steps, head_dim = q.shape
    dims = (u64 * 3)(head_dim, time_steps, batch * heads)
    strides = (u64 * 2)(head_dim * 2, time_steps * head_dim * 2)
    box, unit = (u32 * 3)(64, 128, 1), (u32 * 3)(1, 1, 1)
    buf = ctypes.create_string_buffer(128 + 64)
    cmap = (ctypes.addressof(buf) + 63) // 64 * 64   # CUtensorMap: 128 bytes, 64-aligned
    # BFLOAT16 = 9, INTERLEAVE_NONE = 0, SWIZZLE_128B = 3, L2_PROMOTION_L2_256B = 3,
    # FLOAT_OOB_FILL_NONE = 0 (cuda.h).
    args = (cmap, 9, 3, q.data_ptr(), dims, strides, box, unit, 0, 3, 3, 0)
    if encode(*args) != 0:
        raise AssertionError('cuTensorMapEncodeTiled refused the map of K5b\'s q')
    start = time.perf_counter()
    for _ in range(reps):
        encode(*args)
        encode(*args)
        encode(*args)
    return (time.perf_counter() - start) / reps * 1e6


def bf16_kernels_phase(torch, dev):
    """The bf16-compute kernels against their plain versions on the card, at
    the shapes the bf16 serving paths give them and at edge shapes: K1c at
    B16 T1024 H512 (the LSTM's serving batch) and B1 T64 with the carried
    state (a streamed chunk) on the cluster kernel, with edge shapes at H
    512, 64 and 200, and at H1024 B16 T1024 on the grid build; K3c at H64 B16 T1024 (F0Model) and H128 B32
    T128 (DurationModel); K5b at B16 H4 T1024 dh 96 (the serving batch) and
    B32 (the training batch) with full, causal, windowed (256) masks and
    ragged seq_len, an empty row at B16. Returns the main shapes' numbers."""
    main = {'k1c': k1c_case(torch, dev, SERVE_BATCH, 1024, False, 101, timed=True)}
    main['k1c_chunk'] = k1c_case(torch, dev, 1, STREAM_CONFIG[0], True, 102, timed=True)
    for batch, steps in ((5, 1), (40, 33), (256, 9)):
        k1c_case(torch, dev, batch, steps, True, 103, timed=False)
    # The cluster kernel at the other widths (64: 2 CTAs; 200 padded to 256:
    # 8 CTAs), then the grid build that H = 1024 takes, at the serving shape.
    for hidden in (64, 200):
        k1c_case(torch, dev, 87, 33, True, 103, timed=False, hidden=hidden)
    main['k1c_grid'] = k1c_case(torch, dev, SERVE_BATCH, 1024, False, 104, timed=True,
                                hidden=1024)
    main['k3c'] = k3c_case(torch, dev, SERVE_BATCH, 1024, 64, 256, False, 104, timed=True)
    k3c_case(torch, dev, TRAIN_BATCH, 128, 128, 128, True, 105, timed=True)
    for hidden in (64, 128):
        for batch, steps in ((1, 17), (5, 1), (40, 33)):
            k3c_case(torch, dev, batch, steps, hidden, hidden, True, 106, timed=False)
    main['k5b'] = k5b_case(torch, dev, SERVE_BATCH, 4, 1024, 96, False, None, 107, timed=True)
    for causal, window, empty in ((True, None, False), (True, 256, False), (False, None, True)):
        k5b_case(torch, dev, SERVE_BATCH, 4, 1024, 96, causal, window, 108, timed=True,
                 empty_row=empty)
    for causal, window in ((False, None), (True, None), (True, 256)):
        k5b_case(torch, dev, TRAIN_BATCH, 4, 1024, 96, causal, window, 110, timed=True)
    for batch, steps, head_dim, causal, window, empty in (
            (4, 1, 96, False, None, False), (3, 77, 96, True, 8, True),
            (2, 200, 64, True, 16, True), (3, 130, 128, False, None, True)):
        k5b_case(torch, dev, batch, 4, steps, head_dim, causal, window, 109, timed=False,
                 empty_row=empty)
    return main


# ---------------------------------------------------------- bf16 training

def attention_bf16_bwd_bound(batch, heads, time_steps, head_dim, pairs, rows):
    """Least time for K5b's backward on the route it takes: q.k^T (2 * P *
    dh flops on bf16 operands) at the bf16 tensor-core peak, and the four
    products with an f32 operand (do.v^T, P^T.do, dS.k, dS^T.q: 8 * P * dh)
    as mixed_product_ms (three bf16 passes); 2 * P exp at the SFU rate; bf16 q,
    k, v and f32 do and lse read on the `rows` rows below seq_len and bf16
    dq, dk, dv written on every row at the memory rate. Returns (bound_ms, bound_by, simt_bound_ms), the last the flops
    once at the f32 peak, or the bytes."""
    width = heads * head_dim
    flops = 10.0 * pairs * head_dim
    ops_ms = max(2.0 * pairs * head_dim / BF16_PEAK_FLOPS * 1e3
                 + mixed_product_ms(8.0 * pairs * head_dim), 2 * pairs / SFU_EXP_PER_S * 1e3)
    nbytes = (2.0 * 3 * rows * width + 4.0 * (rows * width + heads * rows)
              + 2.0 * 3 * batch * time_steps * width)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), 'operations' if ops_ms >= bytes_ms else 'bytes',
            max(flops / F32_PEAK_FLOPS * 1e3, bytes_ms))


def hold_within(label, got, want):
    """hold_bf16's bound alone, where the bf16 roundings have no step to act
    on (T <= 1) and the f32 plain version may agree with the bf16 one."""
    out = {'max_abs_err_vs_plain': max((max_abs(a - b) for a, b in zip(got, want)), default=0.0)}
    if not all(max_abs(a - b) <= bf16_tol(b) for a, b in zip(got, want)):
        raise AssertionError(f'{label} disagrees with its plain version: {out}')
    return out


def carry_case(torch, h_prev, dg, label, timed):
    """The bf16 weight-gradient carry on `h_prev` (T, B, H) and `dg` (T, B,
    G) against its plain version (hold_bf16, closer to it than to the f32
    sum rounded once); with `timed`, the kernel, its plain version, the one
    f32 GEMM of the f32 path and the bound."""
    from morgana_tpu_torch.ops import weight_grad

    time_steps, batch, hidden = h_prev.shape
    gates = dg.shape[2]
    got = weight_grad.bf16_weight_grad(h_prev, dg)
    want = weight_grad.bf16_weight_grad_reference(h_prev, dg)
    gemm = lambda: torch.einsum('tbh,tbg->hg', h_prev, dg)  # noqa: E731
    once = torch.einsum('tbh,tbg->hg', h_prev.to(torch.bfloat16).float(), dg)
    if torch.equal(want, once.to(torch.bfloat16).float()):
        # One step contributes (T = 1, or every row of length 1): the carry
        # is the f32 sum rounded once, and the bound alone holds it.
        held = hold_within(f'bf16 carry {label}', [got], [want])
    else:
        held = hold_bf16(f'bf16 carry {label}', [got], [want], [once.to(torch.bfloat16)], 1)
    out = {'T': time_steps, 'B': batch, 'H': hidden, 'G': gates, **held}
    if timed:
        out['kernel_ms'] = cuda_ms(torch, lambda: weight_grad.bf16_weight_grad(h_prev, dg), 5)
        out['plain_ms'] = cuda_ms(
            torch, lambda: weight_grad.bf16_weight_grad_reference(h_prev, dg), 2)
        out['f32_gemm_ms'] = cuda_ms(torch, gemm, 5)
        out['bound_ms'], out['bound_by'] = carry_bound(batch, time_steps, hidden, gates)
        out['library_ms'] = None
    return out


def k2c_case(torch, dev, batch, time_steps, with_state, seed, timed, hidden=H, layer_held=True):
    """The bf16 gradient path of lstm_layer (the bf16 input GEMM and its
    gradient, K1c writing its gate trace, K2c, the bf16 carry of dW_hh)
    against the plain versions in the same autograd Function
    (lstm_layer_reference with compute_dtype bf16): hold_bf16, closer to
    them than to the f32 plain gradients; K1c's gate trace, K2c alone and
    the carry alone against their plain versions on the same inputs
    likewise. K1c and K2c take the route the width gives (the cluster
    kernels up to 512, the grid builds at 1024). With `layer_held` False
    the layer's gradients are reported, not held (the kernels alone still
    are). With `timed`, times of K1c
    with gates, K2c and the carry beside their plain versions and bounds,
    the layer forward+backward and cuDNN's LSTM forward+backward in bf16.
    Returns the kernels' numbers."""
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.ops import precision
    from morgana_tpu_torch.ops import weight_grad

    x, weights, seq_len, h0, c0 = layer_inputs(torch, dev, batch, time_steps, with_state, seed,
                                               hidden)
    rng = np.random.default_rng(seed + 100)
    loss_weights = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                    for shape in ((batch, time_steps, hidden), (batch, hidden), (batch, hidden))]
    route = lstm_ops.bf16_route(hidden)

    def bf16(fn):
        return lambda *a, **k: fn(*a, compute_dtype='bfloat16', **k)

    counts = [(lstm_ops, 'bf16_compute_gate_launches'), (lstm_ops, 'bf16_compute_bwd_launches'),
              (weight_grad, 'launches'), (lstm_ops, 'bf16_cluster_gate_launches'),
              (lstm_ops, 'bf16_cluster_bwd_launches')]
    before = [getattr(m, c) for m, c in counts]
    got = layer_grads(torch, bf16(lstm_ops.lstm_layer), x, weights, seq_len, h0, c0, loss_weights)
    torch.cuda.synchronize()
    launched = [getattr(m, c) - b for (m, c), b in zip(counts, before)]
    want = layer_grads(torch, bf16(lstm_ops.lstm_layer_reference), x, weights, seq_len, h0, c0,
                       loss_weights)
    f32 = layer_grads(torch, lstm_ops.lstm_layer_reference, x, weights, seq_len, h0, c0,
                      loss_weights)
    label = f'B={batch} T={time_steps} H={hidden}'
    layer = hold_bf16(f'bf16 LSTM gradients {label}', got, want, f32, 1, held=layer_held)

    w_ih, w_hh, b_ih, b_hh = weights
    zeros = torch.zeros((batch, hidden), device=dev)
    hs, cs = (zeros, zeros) if h0 is None else (h0, c0)
    xg = (precision.matmul(x, w_ih, torch.bfloat16) + (b_ih + b_hh)).transpose(0, 1).contiguous()
    y_k, c_all, g_k, _, _ = lstm_ops.lstm_recurrence(xg, w_hh, hs, cs, with_gates=True,
                                                     compute_bf16=True)
    _, _, g_p, _, _ = lstm_ops.lstm_recurrence_reference(xg, w_hh, hs, cs, True)
    gate_err = max_abs(g_k - g_p)
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
           for shape in ((time_steps, batch, hidden),) * 2 + ((batch, hidden),) * 2]
    bwd_args = (g_k, w_hh, cs, c_all, *cot)
    k2c = lstm_ops.lstm_backward(*bwd_args, compute_bf16=True)
    k2c_held = hold_bf16(f'K2c {label}', k2c, lstm_ops.lstm_backward_reference(
        *bwd_args, compute_bf16=True), lstm_ops.lstm_backward_reference(*bwd_args), 1)
    h_prev = torch.cat([hs[None], y_k])[:time_steps]
    carry = carry_case(torch, h_prev, k2c[0], f'LSTM {label}', timed)

    k1c_gates = {'gate_trace_max_abs_err': gate_err, 'gate_tol': bf16_tol(g_p),
                 'max_abs_err_vs_plain': layer['max_abs_err_vs_plain']}
    out = {'phase': 'k2c', 'route': route, 'B': batch, 'T': time_steps, 'H': hidden,
           'initial_state': with_state, 'layer_grads': layer, 'k2c': k2c_held, 'carry': carry,
           'k1c_gates': k1c_gates, 'k1c_gate_launches': launched[0],
           'k2c_launches': launched[1], 'carry_launches': launched[2],
           'cluster_launches': launched[3:]}
    if route == 'cluster':
        out['plan_tiles_clusters_fit'] = {
            'k1c_gates': lstm_ops.cluster_plan(batch, hidden, True),
            'k2c': lstm_ops.cluster_plan(batch, hidden, backward=True)}
    if timed:
        k2c_held['kernel_ms'] = cuda_ms(
            torch, lambda: lstm_ops.lstm_backward(*bwd_args, compute_bf16=True), 10)
        k2c_held['plain_ms'] = cuda_ms(
            torch, lambda: lstm_ops.lstm_backward_reference(*bwd_args, compute_bf16=True), 2)
        k2c_held['bound_ms'], k2c_held['bound_by'] = k2_bound(batch, time_steps, hidden,
                                                             compute='bfloat16')
        k2c_held['us_per_step'] = k2c_held['kernel_ms'] * 1e3 / time_steps
        k2c_held['f32_k2_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_backward(*bwd_args), 10)
        k1c_gates['kernel_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_recurrence(
            xg, w_hh, hs, cs, with_gates=True, compute_bf16=True), 10)
        k1c_gates['plain_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_recurrence_reference(
            xg, w_hh, hs, cs, True), 2)
        k1c_gates['bound_ms'], k1c_gates['bound_by'] = k1_bound(batch, time_steps, hidden, True,
                                                                compute='bfloat16')
        k1c_gates['us_per_step'] = k1c_gates['kernel_ms'] * 1e3 / time_steps
        out['layer_fwd_bwd_ms'] = cuda_ms(torch, lambda: layer_grads(
            torch, bf16(lstm_ops.lstm_layer), x, weights, seq_len, h0, c0, loss_weights), 5)
        out['f32_layer_fwd_bwd_ms'] = cuda_ms(torch, lambda: layer_grads(
            torch, lstm_ops.lstm_layer, x, weights, seq_len, h0, c0, loss_weights), 5)
        cudnn = cudnn_in(cudnn_layer(torch, dev, *weights), torch.bfloat16)
        hx = None if h0 is None else (h0[None].bfloat16().contiguous(),
                                      c0[None].bfloat16().contiguous())
        x_l, wy = x.to(torch.bfloat16), loss_weights[0].to(torch.bfloat16)

        def cudnn_fwd_bwd():
            y_c, _ = cudnn(x_l, hx)
            (y_c * wy).sum().backward()

        # cuDNN's backward cannot be timed alone: this includes its forward.
        library = cuda_ms(torch, cudnn_fwd_bwd, 5)
        for entry in (k2c_held, k1c_gates):
            entry['library_ms'] = library
    emit(out)
    cluster = int(route == 'cluster')
    if not (gate_err <= bf16_tol(g_p) and launched == [1, 1, 1, cluster, cluster]):
        raise AssertionError(f'K1c with gates / K2c / carry at {label} ({route}): {out}')
    return {'k1c_gates': k1c_gates, 'k2c': k2c_held, 'carry': carry}


def k4c_case(torch, dev, batch, time_steps, hidden, in_dim, with_state, seed, timed):
    """The bf16 gradient path of gru_layer (K3c, hg on rounded operands, K4c,
    the bf16 carry of dW_hh) against the plain versions in the same autograd
    Function (gru_layer_reference with compute_dtype bf16): hold_bf16,
    closer to them than to the f32 plain gradients; K4c alone as the layer
    launches it and the carry alone against their plain versions likewise.
    With `timed`, times of K4c and the carry beside their plain versions
    and bounds, the layer forward+backward and cuDNN's GRU forward+backward
    in bf16. Returns the kernels' numbers."""
    from morgana_tpu_torch.ops import gru as gru_ops
    from morgana_tpu_torch.ops import precision
    from morgana_tpu_torch.ops import weight_grad

    x, weights, seq_len, h0 = gru_inputs(torch, dev, batch, time_steps, hidden, in_dim,
                                         with_state, seed)
    rng = np.random.default_rng(seed + 100)
    loss_weights = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                    for shape in ((batch, time_steps, hidden), (batch, hidden))]

    def bf16(fn):
        return lambda *a, **k: fn(*a, compute_dtype='bfloat16', **k)

    before = (gru_ops.bf16_compute_bwd_launches, weight_grad.launches)
    got = gru_layer_grads(torch, bf16(gru_ops.gru_layer), x, weights, seq_len, h0, loss_weights)
    torch.cuda.synchronize()
    launched = (gru_ops.bf16_compute_bwd_launches - before[0], weight_grad.launches - before[1])
    want = gru_layer_grads(torch, bf16(gru_ops.gru_layer_reference), x, weights, seq_len, h0,
                           loss_weights)
    f32 = gru_layer_grads(torch, gru_ops.gru_layer_reference, x, weights, seq_len, h0,
                          loss_weights)
    label = f'B={batch} T={time_steps} H={hidden}'
    steps_act = time_steps > 1   # past T = 1 the roundings have a step to act on
    if steps_act:
        layer = hold_bf16(f'bf16 GRU gradients {label}', got, want, f32, 1)
    else:
        layer = hold_within(f'bf16 GRU gradients {label}', got, want)

    w_ih, w_hh, b_ih, b_hh = weights
    hs = torch.zeros((batch, hidden), device=dev) if h0 is None else h0
    xg = precision.matmul(x, w_ih, torch.bfloat16) + b_ih
    y, _ = gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, hs, seq_len, compute_bf16=True)
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
           for shape in ((batch, time_steps, hidden), (batch, hidden))]
    h_prev, hg = gru_ops.hidden_gates(w_hh, b_hh, hs, y, batch_first=True,
                                      compute=torch.bfloat16)
    bwd_args = (xg, hg, w_hh, hs, y, *cot, seq_len)
    k4c = gru_ops._gru_bwd_cuda(*bwd_args, compute_bf16=True)
    plain = gru_ops.layer_backward_reference(*bwd_args, compute_bf16=True)
    if steps_act:
        k4c_held = hold_bf16(f'K4c {label}', k4c, plain,
                             gru_ops.layer_backward_reference(*bwd_args), 1)
    else:
        k4c_held = hold_within(f'K4c {label}', k4c, plain)
    dg = torch.cat([k4c[0][..., :2 * hidden], k4c[1]], dim=-1)
    carry = carry_case(torch, h_prev.reshape(batch, time_steps, hidden).transpose(0, 1),
                       dg.transpose(0, 1), f'GRU {label}', timed) if steps_act else None

    out = {'phase': 'k4c', 'B': batch, 'T': time_steps, 'H': hidden, 'in_dim': in_dim,
           'initial_state': with_state, 'layer_grads': layer, 'k4c': k4c_held, 'carry': carry,
           'k4c_launches': launched[0], 'carry_launches': launched[1]}
    if timed:
        k4c_held['kernel_ms'] = cuda_ms(
            torch, lambda: gru_ops._gru_bwd_cuda(*bwd_args, compute_bf16=True), 20)
        k4c_held['plain_ms'] = cuda_ms(
            torch, lambda: gru_ops.layer_backward_reference(*bwd_args, compute_bf16=True), 2)
        k4c_held['bound_ms'], k4c_held['bound_by'] = k4_bound(batch, time_steps, hidden,
                                                             compute='bfloat16')
        k4c_held['us_per_step'] = k4c_held['kernel_ms'] * 1e3 / time_steps
        k4c_held['f32_k4_ms'] = cuda_ms(torch, lambda: gru_ops._gru_bwd_cuda(*bwd_args), 20)
        out['layer_fwd_bwd_ms'] = cuda_ms(torch, lambda: gru_layer_grads(
            torch, bf16(gru_ops.gru_layer), x, weights, seq_len, h0, loss_weights), 10)
        out['f32_layer_fwd_bwd_ms'] = cuda_ms(torch, lambda: gru_layer_grads(
            torch, gru_ops.gru_layer, x, weights, seq_len, h0, loss_weights), 10)
        cudnn = cudnn_in(cudnn_gru(torch, dev, *weights), torch.bfloat16)
        hx = None if h0 is None else h0[None].bfloat16().contiguous()
        x_l, wy = x.to(torch.bfloat16), loss_weights[0].to(torch.bfloat16)

        def cudnn_fwd_bwd():
            y_c, _ = cudnn(x_l, hx)
            (y_c * wy).sum().backward()

        # cuDNN's backward cannot be timed alone: this includes its forward.
        k4c_held['library_ms'] = cuda_ms(torch, cudnn_fwd_bwd, 10)
    emit(out)
    if launched != (1, 1):
        raise AssertionError(f'K4c / carry at {label}: launches {launched}, expected (1, 1)')
    return {'k4c': k4c_held, 'carry': carry}


def k5b_bwd_case(torch, dev, batch, heads, time_steps, head_dim, causal, window, seed, timed,
                 empty_row=False):
    """dq, dk, dv of a loss on the rows below seq_len through
    flash_attention(compute_dtype=bf16) (K5b, then its backward) against
    autograd through the plain bf16 attention, and K5b's backward alone on
    bf16 q, k and v against attention_backward_reference: hold_bf16 at the
    largest |value| of the three (dq and dk are exactly 0 in the plain
    version where a row sees one key), closer to the bf16 plain version
    than to the f32 one; one launch of the bf16 backward. With `timed`, its
    time, its plain version's, the forward+backward, SDPA's forward+backward
    on bf16 q, k, v and the bound."""
    from morgana_tpu_torch.ops import flash_attention as fa

    q, k, v, seq_len = attention_inputs(torch, dev, batch, heads, time_steps, head_dim, seed,
                                        empty_row)
    mask = dict(seq_len=seq_len, causal=causal, window=window)
    rng = np.random.default_rng(seed + 100)
    weight = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(dev)
    weight = weight * valid_rows(torch, seq_len, time_steps)

    def grads(fn, leaves_of=(q, k, v), **kwargs):
        leaves = [t.clone().requires_grad_(True) for t in leaves_of]
        out = fn(*leaves, **mask, **kwargs)
        return torch.autograd.grad((out.float() * weight).sum(), leaves)

    before = (fa.bf16_launches, fa.bf16_bwd_launches)
    got = grads(fa.flash_attention, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launched = (fa.bf16_launches - before[0], fa.bf16_bwd_launches - before[1])
    want = grads(fa.flash_attention_reference, compute_dtype=torch.bfloat16)
    f32 = grads(fa.flash_attention_reference)
    label = f'B={batch} T={time_steps} dh={head_dim}'
    layer = hold_bf16(f'K5b backward path {label}', got, want, f32, 1, common_scale=True)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    o, lse = fa.attention_forward(qb, kb, vb, **mask)
    alone = fa.attention_backward(qb, kb, vb, o, lse, weight, **mask)
    held = hold_bf16(f'K5b backward {label}', alone,
                     fa.attention_backward_reference(qb, kb, vb, weight, **mask), f32, 1,
                     common_scale=True)
    pairs = attention_pairs(seq_len.tolist(), time_steps, heads, causal, window)
    out = {'phase': 'k5b_bwd', 'B': batch, 'H': heads, 'T': time_steps, 'dh': head_dim,
           'causal': causal, 'window': window, 'visible_pairs': pairs, 'path': layer,
           'backward': held, 'dtypes': [str(t.dtype).replace('torch.', '') for t in alone],
           'k5b_launches': launched[0], 'k5b_bwd_launches': launched[1]}
    if timed:
        held['kernel_ms'] = cuda_ms(torch, lambda: fa.attention_backward(
            qb, kb, vb, o, lse, weight, **mask), 10)
        held['plain_ms'] = cuda_ms(torch, lambda: fa.attention_backward_reference(
            qb, kb, vb, weight, **mask), 3)
        o32, lse32 = fa.attention_forward(q, k, v, **mask)
        held['f32_kernel_ms'] = cuda_ms(torch, lambda: fa.attention_backward(
            q, k, v, o32, lse32, weight, **mask), 10)
        out['fwd_bwd_ms'] = cuda_ms(torch, lambda: grads(fa.flash_attention,
                                                        compute_dtype=torch.bfloat16), 10)
        held['library_ms'] = cuda_ms(torch, lambda: grads(
            lambda *a, **m: sdpa(torch, *a, **m), (qb, kb, vb)), 10)
        held['bound_ms'], held['bound_by'], held['simt_bound_ms'] = attention_bf16_bwd_bound(
            batch, heads, time_steps, head_dim, pairs,
            attention_rows(seq_len.tolist(), time_steps))
    emit(out)
    if not (launched == (1, 1) and all(t.dtype == torch.bfloat16 for t in alone)):
        raise AssertionError(f'K5b backward: {out}')
    return held


def bf16_backward_phase(torch, dev):
    """The backward kernels of --compute_dtype bfloat16 training against
    their plain versions on the card, at the shapes the training paths give
    them and at edge shapes: K1c with its gate trace, K2c and the LSTM's
    carry at B32 T1024 H512 (the cluster kernels; edge shapes at H 512, 64
    and 200) and at H1024 (the grid builds); K4c and the GRU's carry at H64 B32 T1024
    (F0Model) and H128 B32 T128 (DurationModel); K5b's backward at B32 H4
    T1024 dh 96, full, causal and windowed (256). Returns the main shapes'
    numbers."""
    lstm = k2c_case(torch, dev, TRAIN_BATCH, 1024, False, 111, timed=True)
    for batch, steps in ((5, 1), (1, 17), (40, 33), (88, 17), (256, 9)):
        k2c_case(torch, dev, batch, steps, True, 112, timed=False)
    for hidden in (64, 200):
        k2c_case(torch, dev, 87, 33, True, 112, timed=False, hidden=hidden)
    # The grid builds that H = 1024 takes (K1c with gates, K2c): the layer's
    # gradients held at B32 T64, the kernels alone held and timed at the
    # training shape, T1024, where the layer's gradients are reported (at
    # H1024 they go past BF16_ULPS there: PERF.md §7).
    k2c_case(torch, dev, TRAIN_BATCH, 64, True, 119, timed=False, hidden=1024)
    wide = k2c_case(torch, dev, TRAIN_BATCH, 1024, False, 119, timed=True, hidden=1024,
                    layer_held=False)
    gru = k4c_case(torch, dev, TRAIN_BATCH, 1024, 64, 256, False, 113, timed=True)
    k4c_case(torch, dev, TRAIN_BATCH, 128, 128, 128, True, 114, timed=True)
    for hidden in (64, 128):
        for batch, steps in ((1, 17), (5, 1), (40, 33), (16, 0)):
            k4c_case(torch, dev, batch, steps, hidden, hidden, True, 115, timed=False)
    attn = k5b_bwd_case(torch, dev, TRAIN_BATCH, 4, 1024, 96, False, None, 116, timed=True)
    for causal, window in ((True, None), (True, 256)):
        k5b_bwd_case(torch, dev, TRAIN_BATCH, 4, 1024, 96, causal, window, 117, timed=True)
    for batch, steps, head_dim, causal, window, empty in (
            (4, 1, 96, False, None, False), (3, 77, 96, True, 8, True),
            (2, 200, 64, True, 16, True), (3, 130, 128, False, None, True)):
        k5b_bwd_case(torch, dev, batch, 4, steps, head_dim, causal, window, 118, timed=False,
                     empty_row=empty)
    return {'k1c_gates': lstm['k1c_gates'], 'k2c': lstm['k2c'], 'carry': lstm['carry'],
            'carry_gru': gru['carry'], 'k4c': gru['k4c'], 'k5b_bwd': attn,
            'k1c_gates_grid': wide['k1c_gates'], 'k2c_grid': wide['k2c']}


@contextlib.contextmanager
def float64_products(torch):
    """Inside, every torch.matmul of two f32 operands sums its products in
    float64 and rounds the result to f32 once: the plain versions' products
    exact but for that rounding, their roundings to bf16 where they were."""
    matmul = torch.matmul

    def exact(a, b):
        if a.dtype == b.dtype == torch.float32:
            return matmul(a.double(), b.double()).float()
        return matmul(a, b)

    torch.matmul = exact
    try:
        yield
    finally:
        torch.matmul = matmul


@contextlib.contextmanager
def plain_in_layer(torch, swapped):
    """Inside, lstm_layer's autograd Function runs the plain version of each
    of `swapped` ('k1c_gates', 'k2c', 'carry') in place of its kernel, the
    others' kernels as before."""
    from morgana_tpu_torch.ops import lstm as lstm_ops

    saved = {name: getattr(lstm_ops, name)
             for name in ('lstm_recurrence', 'lstm_backward', 'bf16_weight_grad')}
    if 'k1c_gates' in swapped:
        lstm_ops.lstm_recurrence = lambda xg, w, h0, c0, with_gates=False, compute_bf16=False: \
            lstm_ops.lstm_recurrence_reference(xg, w, h0, c0, compute_bf16)
    if 'k2c' in swapped:
        lstm_ops.lstm_backward = lstm_ops.lstm_backward_reference
    if 'carry' in swapped:
        lstm_ops.bf16_weight_grad = lstm_ops.bf16_weight_grad_reference
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(lstm_ops, name, fn)


LAYER_GRADS = ('dx', 'dw_ih', 'dw_hh', 'db_ih', 'db_hh', 'dh0', 'dc0')


def lstm_wide_gradient_phase(torch, dev, batch=TRAIN_BATCH, steps=1024, hidden=1024, seed=119):
    """Where the bf16 layer gradient of a 1024-wide LSTM on the grid builds
    (K1c with gates, K2c, the bf16 carry) leaves its plain version, at
    k2c_case's B32 T1024 H1024 seed-119 inputs. First the plain version's
    own spread: its gradients on the card against the same plain version
    with every product summed in float64 (float64_products) and against it
    on the CPU, each relative to the largest |value| of each gradient. Then
    every combination of the three kernels and their plain versions inside
    the layer (plain_in_layer), each against the plain version on the card.
    The bar is BF16_ULPS bf16 ulps (BF16_ULPS * 2**-7 of the largest
    |value|); the verdict names a kernel when the plain version's spread is
    below a third of the bar and swapping that kernel alone for its plain
    version brings dW_hh under the bar, and otherwise says the bar is of the
    order of the plain version's own spread there. Reports; holds nothing."""
    from morgana_tpu_torch.ops import lstm as lstm_ops

    x, weights, seq_len, h0, c0 = layer_inputs(torch, dev, batch, steps, False, seed, hidden)
    rng = np.random.default_rng(seed + 100)
    loss_weights = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                    for shape in ((batch, steps, hidden), (batch, hidden), (batch, hidden))]

    def grads(layer, on=dev):
        moved = [None if t is None else t.to(on) for t in (x, *weights, seq_len, h0, c0)]
        out = layer_grads(torch, lambda *a, **k: layer(*a, compute_dtype='bfloat16', **k),
                          *moved[:1], moved[1:5], *moved[5:], [w.to(on) for w in loss_weights])
        return [g.to(dev) for g in out]

    def rel(got, want):
        return {name: max_abs(g - w) / max(max_abs(w), 1e-30)
                for name, g, w in zip(LAYER_GRADS, got, want)}

    start = time.perf_counter()
    plain = grads(lstm_ops.lstm_layer_reference)
    with float64_products(torch):
        plain64 = grads(lstm_ops.lstm_layer_reference)
    cpu_start = time.perf_counter()
    plain_cpu = grads(lstm_ops.lstm_layer_reference, torch.device('cpu'))
    cpu_seconds = time.perf_counter() - cpu_start
    kernels = ('k1c_gates', 'k2c', 'carry')
    combos = []
    for mask in range(8):
        swapped = [k for i, k in enumerate(kernels) if mask >> i & 1]
        with plain_in_layer(torch, swapped):
            got = grads(lstm_ops.lstm_layer)
        combos.append({'kernels': [k for k in kernels if k not in swapped],
                       'plain': swapped, 'vs_plain': rel(got, plain),
                       'vs_plain_f64': rel(got, plain64)})
    bar = BF16_ULPS * 2.0 ** -7
    spread = rel(plain64, plain)
    error = combos[0]['vs_plain']['dw_hh']
    fixes = [c['plain'][0] for c in combos
             if len(c['plain']) == 1 and c['vs_plain']['dw_hh'] <= bar]
    if spread['dw_hh'] * 3 < bar and error > bar and len(fixes) == 1:
        verdict = f'fault: the grid build of {fixes[0]} errs at H1024'
    elif error <= bar:
        verdict = 'held: the kernels are within the bar'
    else:
        verdict = ('not a fault: the plain version\'s own spread in dW_hh is of the order of '
                   'the bar')
    out = {'phase': 'lstm_wide_gradient', 'B': batch, 'T': steps, 'H': hidden, 'seed': seed,
           'bar': bar, 'kernels_vs_plain_dw_hh': error,
           'spread_f64_vs_plain': spread, 'spread_cpu_vs_plain': rel(plain_cpu, plain),
           'spread_f64_vs_cpu': rel(plain64, plain_cpu), 'cpu_seconds': cpu_seconds,
           'combinations': combos, 'verdict': verdict,
           'seconds': time.perf_counter() - start}
    emit(out)
    return out


# name: (model module, class, the kernels' counters, layers, seed, flags)
BF16_TRAIN_MODELS = (
    ('lstm', 'rnn_spss', 'LSTMAcousticModel', 8, 121, ()),
    ('f0', 'f0_test_model', 'F0Model', F0_LAYERS, 122, ()),
    ('duration', 'duration_model', 'DurationModel', 1, 123, ()),
    ('transformer', 'transformer_spss', 'TransformerAcousticModel', TRANSFORMER_BLOCKS, 124,
     ('--learning_rate', TRANSFORMER_LR)))


def bf16_counters():
    """The launch counters of the bf16 training path, by name: K1c (all, and
    those with the gate trace), K2c, those of them on the cluster kernels, K3c, K4c, K5b and its backward, the
    carry, and every launch of the LSTM, GRU and attention kernels."""
    from morgana_tpu_torch.ops import flash_attention as fa
    from morgana_tpu_torch.ops import gru as gru_ops
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.ops import weight_grad

    return {'k1c': (lstm_ops, 'bf16_compute_launches'),
            'k1c_gates': (lstm_ops, 'bf16_compute_gate_launches'),
            'k2c': (lstm_ops, 'bf16_compute_bwd_launches'),
            'k1c_cluster': (lstm_ops, 'bf16_cluster_launches'),
            'k1c_cluster_gates': (lstm_ops, 'bf16_cluster_gate_launches'),
            'k2c_cluster': (lstm_ops, 'bf16_cluster_bwd_launches'), 'k1': (lstm_ops, 'launches'),
            'k2': (lstm_ops, 'bwd_launches'), 'k3c': (gru_ops, 'bf16_compute_launches'),
            'k4c': (gru_ops, 'bf16_compute_bwd_launches'), 'k3': (gru_ops, 'launches'),
            'k4': (gru_ops, 'bwd_launches'), 'k5b': (fa, 'bf16_launches'),
            'k5b_bwd': (fa, 'bf16_bwd_launches'), 'attn_fwd': (fa, 'launches'),
            'attn_bwd': (fa, 'bwd_launches'), 'carry': (weight_grad, 'launches')}


def builder_run(torch, root, model_class, phase, seed, *flags, model_kwargs=None):
    """Trains `model_class` (with `model_kwargs`, which `flags` then pass
    as --model_kwargs) for 2 epochs with validation through the
    ExperimentBuilder on the train corpus from a seeded epoch_0.npz, then
    five steady-state steps on one full batch and one profiled step.
    Returns the numbers, the launches of the 2-epoch run (every counter set
    to 0 just before it) and the train steps and valid batches it took."""
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder
    from morgana_tpu_torch.ops import mlpg as mlpg_ops

    data_root, _ = train_corpus(root)
    ckpt = seeded_checkpoint(torch, model_class, os.path.join(root, f'{phase}_init', 'epoch_0.npz'),
                             seed, **(model_kwargs or {}))
    exp_base = os.path.join(root, 'experiments')
    args = ExperimentBuilder.get_experiment_args(
        builder_argv(data_root, exp_base, phase, ckpt, '--end_epoch', '2', *flags))
    exp = ExperimentBuilder(model_class, **args)
    counters = bf16_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for module, name in counters.values():
        setattr(module, name, 0)
    mlpg_before = mlpg_ops.fused_launches
    start = time.perf_counter()
    exp.run_experiment()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    launches = {key: getattr(module, name) for key, (module, name) in counters.items()}
    mlpg_launches = mlpg_ops.fused_launches - mlpg_before
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    exp_dir = os.path.join(exp_base, phase)
    metrics = {}
    for mode in ('train', 'valid'):
        for epoch in (1, 2):
            with open(os.path.join(exp_dir, mode, f'epoch_{epoch}', 'metrics.json')) as f:
                metrics[f'{mode}_{epoch}'] = json.load(f)
    step_losses = [x for epoch in (1, 2) for x in exp.train_losses[epoch]]
    values = step_losses + [v for m in metrics.values() for v in m.values()]
    if len(step_losses) != 2 * len(exp.train_loader) or not all(math.isfinite(v)
                                                                 for v in values):
        raise AssertionError(f'{phase}: non-finite or missing losses/metrics: {step_losses} '
                             f'{metrics}')
    with open(os.path.join(exp_dir, 'config.json')) as f:
        config_dtype = json.load(f)['compute_dtype']
    features, step_ms, profile = time_train_steps(torch, exp)
    with mlpg_timer(torch) as mlpg_ms:     # the MLPG of one train step
        exp.loop.train_step(features, exp.learning_rate)
        torch.cuda.synchronize()
    numbers = {'compute_dtype': config_dtype, 'run_seconds': run_s,
               'mlpg_launches': mlpg_launches, 'mlpg_ms': mlpg_ms[0],
               'median_step_ms_after_first': float(np.median(step_ms[1:])), 'step_ms': step_ms,
               'epoch_2_frames_per_s': metrics['train_2'].get('frames_per_sec', 'not measured'),
               'peak_memory_mib': peak_mib, 'device_busy_ms': profile['device_busy_ms'],
               'device_idle_share': profile['device_idle_share'],
               'profiled_wall_ms': profile['profiled_wall_ms'],
               'device_ms': {k: v for k, v in profile.items() if k.endswith('_device_ms')},
               'step_losses': step_losses, 'valid_loss_2': metrics['valid_2']['loss']}
    return numbers, launches, 2 * len(exp.train_loader), len(exp.valid_loader)


def bf16_training_phase(torch, root, smi):
    """The four models the port trains (LSTMAcousticModel with the scan
    backend at full width, F0Model, DurationModel, TransformerAcousticModel
    at lr 0.001), each trained for 2 epochs (B=32, Adam) through the
    ExperimentBuilder in f32 and then with --compute_dtype bfloat16, from
    one seeded init: ms a step, frames/s, peak memory and the device's idle
    share of each, side by side (one turn each); the bf16 run launches only
    the bf16 builds (K1c with and without gates, K2c, all of them the
    cluster kernels at H512, K3c, K4c, K5b and its backward, the carry), as
    many as its layers, steps and valid batches give; then 3 steps of B=4 on the card against the CPU bf16 trainer
    (train_parity_phase). Returns the bf16 runs' launches, summed."""
    import importlib

    totals = dict.fromkeys(bf16_counters(), 0)
    with compute_dtype(None):
        for name, module, cls, layers, seed, flags in BF16_TRAIN_MODELS:
            model_class = getattr(importlib.import_module(f'morgana_tpu_torch.models.{module}'),
                                  cls)
            f32, _, _, _ = builder_run(torch, root, model_class, f'f32_train_{name}', seed,
                                       *flags)
            bf16, launches, steps, valid = builder_run(
                torch, root, model_class, f'bf16_train_{name}', seed, '--compute_dtype',
                'bfloat16', *flags)
            fwd, per = layers * (steps + 2 * valid), layers * steps
            expected = dict.fromkeys(totals, 0)
            if name == 'lstm':
                expected.update(k1c=fwd, k1=fwd, k1c_gates=per, k2c=per, k2=per, carry=per,
                                k1c_cluster=fwd, k1c_cluster_gates=per, k2c_cluster=per)
            elif name == 'transformer':
                expected.update(k5b=fwd, attn_fwd=fwd, k5b_bwd=per, attn_bwd=per)
            else:
                expected.update(k3c=fwd, k3=fwd, k4c=per, k4=per, carry=per)
            emit({'phase': f'bf16_train_{name}', 'model': cls, 'batch_size': TRAIN_BATCH,
                  'epochs': 2, 'train_steps': steps, 'valid_batches': valid, 'layers': layers,
                  'f32': f32, 'bf16': bf16, 'launches': launches,
                  'launches_expected': expected, 'nvidia_smi': smi})
            if launches != expected or bf16['compute_dtype'] != 'bfloat16':
                raise AssertionError(f'bf16_train_{name}: launches {launches}, expected '
                                     f'{expected}; config {bf16["compute_dtype"]}')
            for key, value in launches.items():
                totals[key] += value
            train_parity_phase(torch, root, model_class, f'bf16_train_parity_{name}', seed + 10,
                               '--compute_dtype', 'bfloat16', *flags,
                               grad_rtol=BF16_ULPS * 2.0 ** -7)
    return totals


# The LSTM voice whose bf16 layers take the grid route (bf16_route): its
# bf16 w_hh, 8 MiB a layer, fits no cluster.
WIDE_LSTM = {'num_layers': 2, 'hidden_size': 1024}


def bf16_wide_lstm_phase(torch, root, served, smi):
    """The main path of K1c and K2c's grid route (H = 1024): a seeded
    LSTMAcousticModel of 2 x LSTM(1024) served in bf16 over the serving
    phase's 32 utterances at B16 (2 K1c launches a batch on the grid build,
    none on the cluster kernel; shapes and finiteness), then trained for 2
    epochs with --compute_dtype bfloat16 through the ExperimentBuilder
    (builder_run): K1c with and without its gate trace and K2c on the grid
    builds, as many as its layers, steps and valid batches give. Returns the
    launches of both runs."""
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.serve import InferenceEngine

    layers = WIDE_LSTM['num_layers']
    ckpt = seeded_checkpoint(torch, LSTMAcousticModel,
                             os.path.join(root, 'wide_lstm', 'epoch_1.npz'), 131, **WIDE_LSTM)
    engine = InferenceEngine(LSTMAcousticModel, ckpt, data_root=served['root'],
                             batch_size=SERVE_BATCH, model_kwargs=WIDE_LSTM,
                             compute_dtype='bfloat16')
    items = served['items']
    n_batches = -(-len(items) // SERVE_BATCH)
    counts = ('bf16_compute_launches', 'bf16_cluster_launches')
    with compute_dtype('bfloat16'):
        engine.predict_items(items[:2])   # warm-up
        torch.cuda.synchronize()
        before = [getattr(lstm_ops, c) for c in counts]
        start = time.perf_counter()
        outputs = engine.predict_items(items)
        seconds = time.perf_counter() - start
        serve = [getattr(lstm_ops, c) - b for c, b in zip(counts, before)]
    for item in items:
        n = int(item['n_frames'].reshape(-1)[0])
        for key, dim in ACOUSTIC_DIMS.items():
            out = outputs[item['name']][key]
            if out.shape != (n, dim) or not np.isfinite(out).all():
                raise AssertionError(f"bf16_wide_lstm {item['name']} {key}: {out.shape}")
    numbers, launches, steps, valid = builder_run(
        torch, root, LSTMAcousticModel, 'bf16_train_lstm_wide', 132, '--compute_dtype',
        'bfloat16', '--model_kwargs', repr(WIDE_LSTM), model_kwargs=WIDE_LSTM)
    fwd, per = layers * (steps + 2 * valid), layers * steps
    expected = dict.fromkeys(launches, 0)
    expected.update(k1c=fwd, k1=fwd, k1c_gates=per, k2c=per, k2=per, carry=per)
    emit({'phase': 'bf16_wide_lstm', 'model': 'LSTMAcousticModel 609-2xLSTM(1024)-199',
          'route': lstm_ops.bf16_route(WIDE_LSTM['hidden_size']),
          'serving': {'utterances': len(items), 'batches': n_batches, 'seconds': seconds,
                      'ms_per_batch': seconds / n_batches * 1e3, 'k1c_launches': serve[0],
                      'cluster_launches': serve[1]},
          'train': numbers, 'train_steps': steps, 'valid_batches': valid, 'launches': launches,
          'launches_expected': expected, 'nvidia_smi': smi})
    if serve != [layers * n_batches, 0] or launches != expected:
        raise AssertionError(f'bf16_wide_lstm: serving launches {serve}, training {launches}, '
                             f'expected {expected}')
    return {'k1c': serve[0] + launches['k1c'] - launches['k1c_gates'],
            'k1c_gates': launches['k1c_gates'], 'k2c': launches['k2c']}


def hold_engines(label, got, want, control, keys):
    """A bf16 card engine's outputs `got` against the bf16 CPU engine's
    `want` (both {name: outputs}): each key within BF16_ULPS bf16 ulps of its
    largest |value| over the utterances, and closer in mean |error| to them
    than the f32 card engine's `control` is. Returns the numbers."""
    errs = {}
    for key in keys:
        scale = max(float(np.abs(want[n][key]).max()) for n in want)
        errs[key] = max(float(np.abs(got[n][key] - want[n][key]).max()) for n in want)
        if errs[key] > BF16_ULPS * 2.0 ** -7 * scale:
            raise AssertionError(f'{label} {key}: {errs[key]} from the CPU engine, beyond '
                                 f'{BF16_ULPS} bf16 ulps at {scale}')

    def mean_err(outputs):
        return float(np.mean(np.concatenate([np.abs(outputs[n][k] - want[n][k]).ravel()
                                             for n in want for k in keys])))
    near, far = mean_err(got), mean_err(control)
    if not near < far:
        raise AssertionError(f'{label}: the bf16 card engine is not closer to the bf16 CPU '
                             f'engine ({near}) than the f32 card engine ({far})')
    return {'max_abs_err': errs, 'mean_err_bf16': near, 'mean_err_f32_engine': far,
            'tolerance': f'{BF16_ULPS} bf16 ulps at each output\'s max; mean below the f32 '
                         "engine's"}


def moe_routes(torch, engine, items):
    """`items` served as one batch by `engine`, a forward hook on each of
    its MoEFeedForward blocks recomputing the block's router on its input as
    the block does. Returns the outputs and, block by block, each frame's
    expert and router probabilities ((B, T) and (B, T, E) numpy arrays)."""
    from morgana_tpu_torch import nn

    routes = []

    def record(module, args, _):
        probs = torch.softmax(torch.matmul(args[0].float(), module.router.weight.float()),
                              dim=-1).detach()
        routes.append((torch.argmax(probs, dim=-1).cpu().numpy(), probs.cpu().numpy()))
    handles = [m.register_forward_hook(record) for m in engine.model.modules()
               if isinstance(m, nn.MoEFeedForward)]
    try:
        outputs = engine.predict_items(items)
    finally:
        for handle in handles:
            handle.remove()
    return outputs, routes


def rows_routed_alike(label, held, cpu, card_routes, cpu_routes):
    """The CPU engine's outputs `cpu` of the rows of `held` that the card
    and CPU engines routed alike in every MoE block (moe_routes), and the
    numbers of the rows routed apart. Fails if a row routed apart was first
    routed apart at a token whose two experts' probabilities are more than
    ROUTE_TIE apart on either engine, or if no row was routed alike."""
    alike, apart = {}, []
    for row, item in enumerate(held):
        n = int(item['n_frames'].reshape(-1)[0])
        for block, ((e_card, p_card), (e_cpu, p_cpu)) in enumerate(zip(card_routes,
                                                                       cpu_routes)):
            tokens = np.nonzero(e_card[row, :n] != e_cpu[row, :n])[0]
            if tokens.size:
                a, b = e_card[row, tokens], e_cpu[row, tokens]
                gaps = np.maximum(p_card[row, tokens, a] - p_card[row, tokens, b],
                                  p_cpu[row, tokens, b] - p_cpu[row, tokens, a])
                apart.append({'utterance': item['name'], 'frames': n, 'moe_block': block,
                              'tokens': int(tokens.size), 'max_gap': float(gaps.max())})
                if gaps.max() > ROUTE_TIE:
                    raise AssertionError(f'{label}: {item["name"]} routed apart in MoE block '
                                         f'{block} at a gap of {gaps.max()}, beyond {ROUTE_TIE}')
                break
        else:
            alike[item['name']] = cpu[item['name']]
    if not alike:
        raise AssertionError(f'{label}: no row routed alike on the card and the CPU: {apart}')
    return alike, {'rows_routed_apart': apart, 'route_tie': ROUTE_TIE}


def bf16_engine_case(torch, name, model_class, ckpt, root, items, dims, ops, attr, layers, label,
                     model_kwargs=None, mlpg_per_batch=1):
    """`model_class` (with `model_kwargs`) served by an f32 engine and a bf16
    engine (compute_dtype='bfloat16') on the card over `items` at B16, in
    turns (f32, bf16, bf16, f32; the process's compute dtype set for each
    call): every bf16 batch launches `layers` kernels of `ops`, all of them
    its bf16 build (`attr`), and every f32 batch none, and `mlpg_per_batch`
    MLPG launches a batch; shapes and finiteness; the timed outputs of one
    batch (cpu_held_batch) against the bf16 CPU engine (hold_engines; a
    mixture of experts row by row, rows_routed_alike); frames/s,
    ms a batch, peak memory and, profiled on one batch, device busy time and
    idle share, each beside the f32 engine's. Returns the bf16 launches, the
    bf16 engine and its outputs."""
    from morgana_tpu_torch import data, nn
    from morgana_tpu_torch.ops import mlpg as mlpg_ops
    from morgana_tpu_torch.serve import InferenceEngine

    common = dict(data_root=root, batch_size=SERVE_BATCH, model_kwargs=model_kwargs)
    engines = {'float32': InferenceEngine(model_class, ckpt, **common),
               'bfloat16': InferenceEngine(model_class, ckpt, compute_dtype='bfloat16', **common)}
    for tag, engine in engines.items():
        with compute_dtype(tag):
            engine.predict_items(items[:2])   # warm-up: cuBLAS handles, allocator
    n_batches = -(-len(items) // SERVE_BATCH)
    expected = layers * n_batches
    runs, outputs, bf16_launches = {tag: [] for tag in engines}, {}, 0
    frames = sum(int(it['n_frames'].reshape(-1)[0]) for it in items)
    for tag in ('float32', 'bfloat16', 'bfloat16', 'float32'):
        with compute_dtype(tag):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.launches = 0
            setattr(ops, attr, 0)
            mlpg_before = mlpg_ops.fused_launches
            start = time.perf_counter()
            outputs[tag] = engines[tag].predict_items(items)   # host arrays: synchronised
            seconds = time.perf_counter() - start
            launched = (ops.launches, getattr(ops, attr))
            mlpg_launches = mlpg_ops.fused_launches - mlpg_before
        if launched != (expected, expected if tag == 'bfloat16' else 0) \
                or mlpg_launches != mlpg_per_batch * n_batches:
            raise AssertionError(f'bf16_serving {name} {tag}: launches {launched} for '
                                 f'{n_batches} batches of {layers} layers, MLPG '
                                 f'{mlpg_launches}')
        bf16_launches += launched[1]
        runs[tag].append({'seconds': seconds, 'frames_per_s': frames / seconds,
                          'mlpg_launches': mlpg_launches,
                          'ms_per_batch': seconds / n_batches * 1e3,
                          'peak_memory_mib': torch.cuda.max_memory_allocated() / 2 ** 20})
    for item in items:
        n = int(item['n_frames'].reshape(-1)[0])
        out = outputs['bfloat16'][item['name']]
        for key, dim in dims.items():
            if out[key].shape != (n, dim) or not np.isfinite(out[key]).all():
                raise AssertionError(f"bf16_serving {name} {item['name']} {key}: shape "
                                     f'{out[key].shape}, expected ({n}, {dim})')
    # The timed outputs of one batch (cpu_held_batch) against the bf16 CPU
    # engine's; a MoE model's row by row (moe_routes, rows_routed_alike).
    held = cpu_held_batch(items)
    routed = any(isinstance(m, nn.MoEFeedForward) for m in engines['bfloat16'].model.modules())
    routing = {}
    with compute_dtype('bfloat16'):
        cpu_engine = InferenceEngine(model_class, ckpt, device='cpu', **common)
        if routed:
            cpu, cpu_routes = moe_routes(torch, cpu_engine, held)
            _, card_routes = moe_routes(torch, engines['bfloat16'], held)
            cpu, routing = rows_routed_alike(f'bf16_serving {name}', held, cpu, card_routes,
                                             cpu_routes)
        else:
            cpu = cpu_engine.predict_items(held)
    check = hold_engines(f'bf16_serving {name}', outputs['bfloat16'], cpu, outputs['float32'],
                         dims)
    check.update(utterances=len(cpu), **routing)
    features = data.collate([data.assemble_item(
        engines['bfloat16'].model.test_data_sources(), engines['bfloat16'].model.normalisers,
        lambda key, source, item=item: source.package(item[key]), item['name'])
        for item in items[:SERVE_BATCH]])
    profiles = {}
    for tag, engine in engines.items():
        batch = data.device_features(features, engine.device)
        with compute_dtype(tag), torch.inference_mode():
            engine.model.predict(batch)
            with mlpg_timer(torch) as mlpg_ms:
                engine.model.predict(batch)
            profiles[tag] = dict(profile_step(torch, lambda: engine.model.predict(batch)),
                                 mlpg_ms=mlpg_ms[0])
    summary = {tag: {key: float(np.mean([r[key] for r in runs[tag]])) for key in runs[tag][0]}
               for tag in runs}
    for tag in summary:
        summary[tag].update({key: profiles[tag][key] for key in (
            'profiled_wall_ms', 'device_busy_ms', 'device_idle_share', 'gemm_device_ms',
            'k1_device_ms', 'k1c_device_ms', 'k3_device_ms', 'k3c_device_ms',
            'attn_fwd_device_ms', 'k5b_device_ms', 'mlpg_device_ms',
            'other_device_ms', 'kernels_launched', 'launch_mismatch', 'mlpg_ms')})
    emit({'phase': f'bf16_serving_{name}', 'model': label, 'utterances': len(items),
          'frames': frames, 'batch_size': SERVE_BATCH, 'batches': n_batches,
          'runs_in_turns': runs, 'float32': summary['float32'], 'bfloat16': summary['bfloat16'],
          'frames_per_s_ratio': summary['bfloat16']['frames_per_s']
          / summary['float32']['frames_per_s'],
          f'{attr}_per_bf16_run': expected, 'cpu_check': check,
          'profiled_batch_T': int(features['normalised_counters'].shape[1])})
    return bf16_launches, engines['bfloat16'], outputs['bfloat16']


def bf16_stream_case(torch, name, engine, items, batch, ops, attr, per_chunk):
    """Each of `items` streamed at STREAM_CONFIG by the bf16 engine `engine`:
    `per_chunk` launches of `ops` a chunk, all of them its bf16 build
    (`attr`), or with per_chunk 0 none at all (the Transformer's plain
    attention step); every chunk's network outputs against the engine's
    batch predict `batch` within BF16_ULPS bf16 ulps of each output's
    largest |value|. Returns the numbers and the bf16 launches."""
    from morgana_tpu_torch.pipeline import TTSPipeline

    sources = {k: v for k, v in engine.model.test_data_sources().items()
               if k in TTSPipeline.ACOUSTIC_INPUTS}
    per_utt, errs, launches = [], {}, 0
    for item in items:
        n_frames = int(item['n_frames'].reshape(-1)[0])
        chunks = -(-n_frames // STREAM_CONFIG[0])
        with compute_dtype('bfloat16'), stream_timers(torch, engine.model, NET_OUTPUTS) as rec:
            torch.cuda.synchronize()
            ops.launches = 0
            setattr(ops, attr, 0)
            start = time.perf_counter()
            list(engine.stream_item(item, *STREAM_CONFIG, sources=sources))
            seconds = time.perf_counter() - start
            launched = (ops.launches, getattr(ops, attr))
        if launched != (per_chunk * chunks,) * 2:
            raise AssertionError(f'bf16 stream {name}: launches {launched} for {chunks} chunks')
        launches += launched[1]
        got = streamed(torch, rec['outputs'], n_frames, NET_OUTPUTS)
        for key in NET_OUTPUTS:
            want = batch[item['name']][key]
            err = float(np.abs(got[key] - want).max())
            errs[key] = max(errs.get(key, 0.0), err)
            if err > BF16_ULPS * 2.0 ** -7 * float(np.abs(want).max()):
                raise AssertionError(f'bf16 stream {name} {key}: {err} from the batch')
        per_utt.append({'utterance': item['name'], 'frames': n_frames, 'chunks': chunks,
                        'seconds': seconds, 'ms_per_chunk': chunk_ms(rec, chunks, ('model',)),
                        'launches': launched[1]})
    return {'utterances': per_utt, 'network_vs_batch': errs,
            'tolerance': f'{BF16_ULPS} bf16 ulps at each output\'s max'}, launches


PIPELINE_RUN = r'''
import contextlib, io, json, sys, time
start = time.perf_counter()
from morgana_tpu_torch import nn, pipeline
from morgana_tpu_torch.ops import gru, lstm
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    pipeline.main(sys.argv[1:])
print(json.dumps({'stats': json.loads(printed.getvalue().strip().splitlines()[-1]),
                  'k1': lstm.launches, 'k1c': lstm.bf16_compute_launches,
                  'k1c_cluster': lstm.bf16_cluster_launches, 'k3': gru.launches,
                  'k3c': gru.bf16_compute_launches,
                  'compute_dtype': str(nn.default_compute_dtype()),
                  'seconds': time.perf_counter() - start}))
'''


def bf16_serving_phase(torch, served, smi):
    """bf16 serving on the card (--compute_dtype bfloat16): the serving
    phase's LSTMAcousticModel, a seeded F0Model and TransformerAcousticModel
    through bf16_engine_case (K1c 8, K3c 3 and K5b 6 launches a batch); the
    LSTM's 2 longest utterances streamed (8 K1c launches a chunk, with the
    carried state) and a seeded causal Transformer's (the plain bf16
    attention step; their batch 6 K5b launches) through bf16_stream_case;
    one LSTM
    bundle exported under bf16 (B16, one program) and run by ExportedVoice
    in a fresh process (its K1c launches, its outputs against the bf16
    engine's within EXPORT_RTOL); and python -m morgana_tpu_torch.pipeline
    --compute_dtype bfloat16 --device_vocoder --evaluate_against over
    pipeline_lstm's split (its K1c and K3c launches, all of its K1 and K3).
    Returns the bf16 kernels' launches."""
    from morgana_tpu_torch.models.f0_test_model import F0Model
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
    from morgana_tpu_torch.ops import flash_attention as fa
    from morgana_tpu_torch.ops import gru as gru_ops
    from morgana_tpu_torch.ops import lstm as lstm_ops

    from morgana_tpu_torch.serve import InferenceEngine

    base = os.path.join(served['root'], 'bf16')
    os.makedirs(base)
    launches = {'k1c': 0, 'k3c': 0, 'k5b': 0}
    seconds, start = {}, time.perf_counter()

    def lap(name):
        nonlocal start
        seconds[name] = time.perf_counter() - start
        start = time.perf_counter()

    n, lstm_engine, lstm_out = bf16_engine_case(
        torch, 'lstm', LSTMAcousticModel, served['ckpt'], served['root'], served['items'],
        ACOUSTIC_DIMS, lstm_ops, 'bf16_cluster_launches', 8,
        'LSTMAcousticModel 609-8xLSTM(512)-199')
    launches['k1c'] += n
    lap('lstm')
    for name, cls, make, dims, ops, attr, layers, label, seed in (
            ('f0', F0Model, f0_items, {'normalised_lf0_deltas': 3, 'lf0': 1}, gru_ops,
             'bf16_compute_launches', F0_LAYERS, 'F0Model 609-3xGRU(64)-3', 111),
            ('transformer', TransformerAcousticModel, make_items, ACOUSTIC_DIMS, fa,
             'bf16_launches', TRANSFORMER_BLOCKS,
             'TransformerAcousticModel 609-6x(384, 4 heads, 1536)-199', 112)):
        root = os.path.join(base, name)
        os.makedirs(root)
        rng = np.random.default_rng(seed)
        ckpt = seeded_checkpoint(torch, cls, os.path.join(root, 'epoch_1.npz'), seed)
        write_normalisers(root, rng)
        n, _, _ = bf16_engine_case(torch, name, cls, ckpt, root, make(rng), dims, ops, attr,
                                   layers, label)
        launches['k3c' if ops is gru_ops else 'k5b'] += n
        lap(name)

    # The streams: the LSTM's 2 longest utterances (K1c with the carried
    # state), and the causal Transformer's (window 256): its bf16 batch of
    # them (6 K5b launches), then their streams (the plain bf16 attention
    # step over the KV caches).
    longest = sorted(served['items'], key=lambda it: -int(it['n_frames'].reshape(-1)[0]))[:2]
    lstm_stream, n = bf16_stream_case(torch, 'lstm', lstm_engine, longest, lstm_out, lstm_ops,
                                      'bf16_cluster_launches', 8)
    launches['k1c'] += n
    root = os.path.join(base, 'causal_transformer')
    os.makedirs(root)
    rng = np.random.default_rng(113)
    kwargs = {'causal': True}
    ckpt = seeded_checkpoint(torch, TransformerAcousticModel, os.path.join(root, 'epoch_1.npz'),
                             113, **kwargs)
    write_normalisers(root, rng)
    items = sorted(make_items(rng), key=lambda it: -int(it['n_frames'].reshape(-1)[0]))[:2]
    engine = InferenceEngine(TransformerAcousticModel, ckpt, data_root=root,
                             batch_size=SERVE_BATCH, model_kwargs=kwargs, compute_dtype='bfloat16')
    with compute_dtype('bfloat16'):
        engine.predict_items(items[:1])   # warm-up
        fa.launches = fa.bf16_launches = 0
        batch = engine.predict_items(items)
        launched = (fa.launches, fa.bf16_launches)
    if launched != (TRANSFORMER_BLOCKS,) * 2:
        raise AssertionError(f'bf16_serving causal_transformer: launches {launched}')
    launches['k5b'] += launched[1]
    transformer_stream, _ = bf16_stream_case(torch, 'causal_transformer', engine, items, batch, fa,
                                             'bf16_launches', 0)
    lap('streams')

    # One LSTM bundle exported under bf16, run in a fresh process (f32 there:
    # the programs carry their dtype).
    spec = 'morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel'
    with compute_dtype('bfloat16'):
        entry, want, numbers = export_voice(torch, 'lstm_bf16', LSTMAcousticModel, served['ckpt'],
                                            served['root'], served['items'][:SERVE_BATCH], spec,
                                            os.path.join(base, 'bundle'))
    report = run_script('bf16_serving: ExportedVoice', EXPORT_RUN, json.dumps([entry]))
    got = report['voices']['lstm_bf16']
    if report['models_imported'] or got['launches']['k1'] != got['launches']['k1c'] \
            or got['launches']['k1c'] != 8 * numbers['batches'] \
            or got['launches']['k1c_cluster'] != got['launches']['k1c']:
        raise AssertionError(f'bf16_serving export: {report}')
    with np.load(entry['out']) as out:
        export_err = max(float(np.abs(out[key] - value).max())
                         / max(float(np.abs(value).max()), 1e-30) for key, value in want.items())
    if export_err > EXPORT_RTOL:
        raise AssertionError(f'bf16_serving export: {export_err} from the bf16 engine')
    launches['k1c'] += got['launches']['k1c']
    lap('export')

    # The pipeline's command line in bf16, with the card's vocoder, over the
    # split pipeline_lstm wrote.
    root, norm = served['root'], 'pipeline_norm'
    cli_dir = os.path.join(base, 'pipeline_cli')
    cli = run_script('bf16_serving: pipeline CLI', PIPELINE_RUN, '--duration_model',
                     'morgana_tpu_torch.models.duration_model:DurationModel',
                     '--duration_checkpoint', os.path.join(root, norm, 'duration_epoch_0.npz'),
                     '--acoustic_model', spec, '--acoustic_checkpoint', served['ckpt'],
                     '--data_root', root, '--normalisation_dir', norm, '--data_dir', 'pipeline',
                     '--out_dir', cli_dir, '--batch_size', str(SERVE_BATCH), '--device_vocoder',
                     '--evaluate_against', os.path.join(root, 'pipeline'),
                     '--compute_dtype', 'bfloat16')
    stats = cli['stats']
    if stats['utterances'] != N_UTTS or stats['wavs'] != N_UTTS or 'evaluation' not in stats \
            or not cli['k1c'] or cli['k1c'] != cli['k1'] or cli['k1c_cluster'] != cli['k1c'] \
            or not cli['k3c'] \
            or cli['k3c'] != cli['k3'] or cli['compute_dtype'] != 'torch.bfloat16':
        raise AssertionError(f'bf16_serving: the pipeline CLI gave {cli}')
    check_wavs('bf16 pipeline cli', os.path.join(cli_dir, 'synth'),
               {name: int(np.load(os.path.join(cli_dir, 'feats', 'dur', f'{name}.npy')).sum())
                for name in (it['name'] for it in served['items'])})
    launches['k1c'] += cli['k1c']
    launches['k3c'] += cli['k3c']
    lap('pipeline_cli')
    emit({'phase': 'bf16_serving', 'card': smi, 'seconds': seconds, 'stream_lstm': lstm_stream,
          'stream_causal_transformer': transformer_stream,
          'export': dict(numbers, bundle=got, max_rel_err_vs_engine=export_err,
                         rtol=EXPORT_RTOL),
          'pipeline_cli': {'seconds': cli['seconds'], 'seconds_inside': stats['seconds'],
                           'frames_per_sec_inside': stats['frames_per_sec'],
                           'evaluation': stats['evaluation'], 'k1c_launches': cli['k1c'],
                           'k3c_launches': cli['k3c']},
          'launches': launches})
    return launches


# ------------------------------------------------------ the other families

def speaker_items(rng):
    """make_items' utterances, each given a speaker of SPEAKERS in turn."""
    items = make_items(rng)
    for i, item in enumerate(items):
        item['speaker_id'] = SPEAKERS[i % len(SPEAKERS)]
    return items


def write_speaker_normalisers(root, rng):
    """speakers.scp and each speaker's seeded lf0 statistics,
    {root}/train/{speaker}/lf0_mvn.json."""
    with open(os.path.join(root, 'speakers.scp'), 'w') as f:
        f.write('\n'.join(SPEAKERS))
    for speaker in SPEAKERS:
        os.makedirs(os.path.join(root, 'train', speaker))
        with open(os.path.join(root, 'train', speaker, 'lf0_mvn.json'), 'w') as f:
            json.dump({'mean': rng.normal(5.0, 0.3, 1).tolist(),
                       'std_dev': rng.uniform(0.1, 0.5, 1).tolist()}, f)


def speaker_corpus(root):
    """train_corpus' sizes with its utterances spread over SPEAKERS (each
    speaker's lf0 offset, its statistics and speakers.scp). Returns its
    directory and the seconds it took (0 when it was there)."""
    from morgana_tpu_torch.data.synthetic import generate_voice_data

    data_root = os.path.join(root, 'speaker_data')
    if os.path.isdir(data_root):
        return data_root, 0.0
    start = time.perf_counter()
    generate_voice_data(data_root, num_train=64, num_valid=16, num_test=0, seed=9,
                        n_phones_range=(40, 120), dur_range=(5, 10), speakers=list(SPEAKERS))
    return data_root, time.perf_counter() - start


def step_parity(torch, phase, model_class, ckpt, data_root, model_kwargs=None, fixed_noise=False):
    """One train step of `model_class` from `ckpt` on the card and on the
    CPU, on the first 4 training utterances of `data_root` (through
    TrainLoop.train_step, the balance loss of MoE blocks included): the
    losses within TRAIN_LOSS_RTOL and every gradient within TRAIN_GRAD_RTOL
    of its largest |value|. With `fixed_noise` (a VAE) both draw the
    posterior sample from the same seeded noise, since the two devices'
    generators give different draws."""
    from morgana_tpu_torch import data
    from morgana_tpu_torch.training import TrainLoop, build_optimizer

    noise = torch.randn((4, 4096), generator=torch.Generator().manual_seed(7))
    runs = {}
    for device in ('cuda', 'cpu'):
        model = model_class(**(model_kwargs or {}))
        model.load_parameters(ckpt)
        model.normalisers = data.Normalisers(model.normaliser_sources(), 'train', data_root)
        model.mode = 'train'
        model = model.to(device)
        if fixed_noise:
            model.sample = lambda mean, log_var, device=device: mean + torch.exp(
                0.5 * log_var) * noise[:, :mean.shape[1]].to(device)
        dataset = data.FilesDataset(model.train_data_sources(), 'train',
                                    'train/train_file_id_list.scp', model.normalisers, data_root)
        features = data.collate([dataset[i] for i in range(4)])
        loss, _ = TrainLoop(model, build_optimizer('adam')).train_step(features, 0.0)
        runs[device] = (float(loss), {n: p.grad.detach().cpu()
                                      for n, p in model.named_parameters()})
    (gpu_loss, gpu_grads), (cpu_loss, cpu_grads) = runs['cuda'], runs['cpu']
    grad_rel = {n: float((gpu_grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                for n, g in cpu_grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    out = {'B': 4, 'gpu_loss': gpu_loss, 'cpu_loss': cpu_loss,
           'loss_rel_err': abs(gpu_loss - cpu_loss) / abs(cpu_loss), 'loss_rtol': TRAIN_LOSS_RTOL,
           'max_grad_rel_err': grad_rel[worst], 'worst_param': worst,
           'grad_rtol': TRAIN_GRAD_RTOL, 'fixed_noise': fixed_noise}
    if out['loss_rel_err'] > TRAIN_LOSS_RTOL or grad_rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f'{phase}: the card train step disagrees with the CPU one: {out}')
    return out


def family_train_phase(torch, root, phase, model_class, ops, names, layer_class, layers, seed,
                       *flags, model_kwargs=None, corpus=None, fixed_noise=False,
                       mlpg_per_step=1):
    """builder_train_phase, then the train step on the card against the CPU
    (step_parity), five steady-state steps on one full batch, one profiled
    step and the MLPG's share of a step. Returns the launches and the
    experiment."""
    launches, exp, exp_dir = builder_train_phase(
        torch, root, model_class, phase, ops, names, layer_class, layers, seed, *flags,
        model_kwargs=model_kwargs, corpus=corpus, mlpg_per_step=mlpg_per_step)
    parity = step_parity(torch, phase, model_class,
                         os.path.join(root, f'{phase}_init', 'epoch_0.npz'),
                         (corpus or train_corpus)(root)[0], model_kwargs, fixed_noise)
    with open(os.path.join(exp_dir, 'train', 'epoch_2', 'metrics.json')) as f:
        frames_per_s = json.load(f)['frames_per_sec']
    features, step_ms, profile = time_train_steps(torch, exp)
    with mlpg_timer(torch) as mlpg_ms:
        exp.loop.train_step(features, exp.learning_rate)
    emit(dict({'phase': phase + '_step_breakdown', 'B': TRAIN_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'frames': float(np.sum(features['n_frames'])), 'step_ms': step_ms,
               'median_step_ms_after_first': float(np.median(step_ms[1:])),
               'epoch_2_frames_per_s': frames_per_s, 'mlpg_ms': mlpg_ms[0],
               'gpu_vs_cpu_step': parity}, **profile))
    return launches, exp


def vae_latent_case(torch, exp):
    """VAEProsodyModel's test analysis on the card for one valid batch of
    the trained model: VAE_LATENT_SAMPLES latents on the sphere decoded
    (one K3 launch each) into latent_samples/feats/lf0, n_frames long and
    finite. Returns the K3 launches."""
    from morgana_tpu_torch.ops import gru as gru_ops

    features = host_features(next(iter(exp.valid_loader)))
    outputs = exp.loop.predict_step(features)
    out_dir = os.path.join(exp.experiment_dir, 'latent_check')
    gru_ops.launches = 0
    exp.model.analysis_for_test_batch(features, outputs, out_dir)
    launches = gru_ops.launches
    lf0_dir = os.path.join(out_dir, 'latent_samples', 'feats', 'lf0')
    n_frames = np.asarray(features['n_frames']).astype(np.int64).reshape(-1)
    for name, n in zip(features['name'], n_frames):
        for s in range(VAE_LATENT_SAMPLES):
            lf0 = np.load(os.path.join(lf0_dir, f'{name}_sample{s}.npy'))
            if lf0.shape[0] != n or not np.isfinite(lf0).all():
                raise AssertionError(f'vae latent sample {name} {s}: shape {lf0.shape}, '
                                     f'expected {n} frames')
    if launches != VAE_LATENT_SAMPLES:
        raise AssertionError(f'vae latent samples: K3 launched {launches} times')
    return launches


def conv_stream_case(torch, root, smi):
    """The causal ConvAcousticModel at its defaults with seeded weights and
    statistics: the STREAM_UTTS longest of make_items' utterances predicted
    in one batch, then each streamed at STREAM_CONFIG through
    InferenceEngine.stream_item_audio (each convolution's context tail
    carried on the card; MLPG and vocoder on the host). Checks the audio
    length, every chunk's network outputs against the batch within
    NET_TOL, and the shortest streamed on the CPU within NET_TOL /
    TRAJ_RTOL; the streamed trajectories' distance from the batch's is
    recorded, not held, as stream_transformer records it (random weights
    make rough outputs, on which a window of 32 + 64 + 16 frames strays
    from the whole-utterance solve). Records the time to first audio, ms a
    chunk (model, MLPG, vocoder) and the real-time factor. Returns the
    batch's MLPG launches."""
    from morgana_tpu_torch.models.conv_spss import ConvAcousticModel
    from morgana_tpu_torch.ops import mlpg as mlpg_ops
    from morgana_tpu_torch.serve import InferenceEngine

    stream_root = os.path.join(root, 'conv_stream')
    os.makedirs(stream_root)
    rng = np.random.default_rng(131)
    kwargs = {'causal': True}
    ckpt = seeded_checkpoint(torch, ConvAcousticModel, os.path.join(stream_root, 'epoch_1.npz'),
                             131, **kwargs)
    write_normalisers(stream_root, rng)
    items = make_items(rng)
    longest = sorted(items, key=lambda it: -int(it['n_frames'].reshape(-1)[0]))[:STREAM_UTTS]
    engine = InferenceEngine(ConvAcousticModel, ckpt, data_root=stream_root,
                             batch_size=SERVE_BATCH, model_kwargs=kwargs)
    list(engine.stream_item_audio(items[1], *STREAM_CONFIG))      # warm-up
    mlpg_before = mlpg_ops.fused_launches
    batch = engine.predict_items(longest)
    mlpg_launches = mlpg_ops.fused_launches - mlpg_before
    streams, per_utt = {}, []
    for item in longest:
        name, n_frames = item['name'], int(item['n_frames'].reshape(-1)[0])
        with stream_timers(torch, engine.model, NET_OUTPUTS) as rec:
            torch.cuda.synchronize()
            start = time.perf_counter()
            first, pairs = None, []
            for feats, wav in engine.stream_item_audio(item, *STREAM_CONFIG):
                if first is None and wav.shape[0]:
                    first = time.perf_counter() - start
                pairs.append((feats, wav))
            seconds = time.perf_counter() - start
        audio = np.concatenate([w for _, w in pairs])
        if audio.shape != (n_frames * HOP,) or not np.isfinite(audio).all():
            raise AssertionError(f'conv_stream {name}: audio {audio.shape}, expected '
                                 f'({n_frames * HOP},)')
        streams[name] = {k: np.concatenate([c[k] for c, _ in pairs if c])
                         for k in ('lf0', 'vuv', 'mcep', 'bap')}
        streams[name].update(streamed(torch, rec['outputs'], n_frames, NET_OUTPUTS))
        chunks = -(-n_frames // STREAM_CONFIG[0])
        per_utt.append({'utterance': name, 'frames': n_frames, 'chunks': chunks,
                        'audio_seconds': n_frames * HOP / FS, 'seconds': seconds,
                        'time_to_first_audio_ms': first * 1e3,
                        'ms_per_chunk': chunk_ms(rec, chunks),
                        'real_time_factor': n_frames * HOP / FS / seconds})
    errs = hold_features('conv_stream network vs batch', streams, batch, NET_OUTPUTS)
    vs_batch = {key: max(float(np.abs(streams[n][key] - batch[n][key]).max()) for n in streams)
                for key in ('lf0', 'mcep', 'bap')}
    shortest = min(longest, key=lambda it: int(it['n_frames'].reshape(-1)[0]))
    cpu = InferenceEngine(ConvAcousticModel, ckpt, data_root=stream_root, device='cpu',
                          model_kwargs=kwargs)
    cpu_stream = {shortest['name']: {k: np.concatenate([c[k] for c in cpu.stream_item(
        shortest, *STREAM_CONFIG)]) for k in ('lf0', 'vuv', 'mcep', 'bap')}}
    vs_cpu = hold_features('conv_stream vs CPU stream', streams, cpu_stream,
                           ('lf0', 'vuv', 'mcep', 'bap'))

    def mean(key):
        return float(np.mean([u[key] for u in per_utt]))
    emit({'phase': 'conv_stream', 'card': smi,
          'model': 'ConvAcousticModel(causal=True) 609-512-6x(conv k5)-256-199',
          'config': dict(zip(('chunk_frames', 'context', 'lookahead'), STREAM_CONFIG)),
          'utterances': per_utt, 'time_to_first_audio_ms': mean('time_to_first_audio_ms'),
          'ms_per_chunk': {part: float(np.mean([u['ms_per_chunk'][part] for u in per_utt]))
                           for part in per_utt[0]['ms_per_chunk']},
          'real_time_factor': sum(u['audio_seconds'] for u in per_utt)
          / sum(u['seconds'] for u in per_utt),
          'host': "the streamed MLPG and the vocoder run on the card machine's CPU",
          'network_vs_batch': errs, 'trajectories_vs_batch_not_held': vs_batch,
          'cpu_stream_check': {'utterance': shortest['name'], **vs_cpu},
          'batch_mlpg_launches': mlpg_launches})
    if mlpg_launches != 1:
        raise AssertionError(f'conv_stream: {mlpg_launches} MLPG launches for one batch')
    return mlpg_launches


@contextlib.contextmanager
def tf32_as_users_get(torch, label):
    """PyTorch's default cuDNN TF32 (on) inside, which main turned off for
    the library yardsticks: the convolutions inside run as in a user's
    process, so they are IEEE f32 only if the port turns TF32 off itself
    (device.use_ieee_f32). Fails if it is still on after; off after."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
        if torch.backends.cudnn.allow_tf32:
            raise AssertionError(f'{label}: the port left cuDNN TF32 on')
    finally:
        torch.backends.cudnn.allow_tf32 = False


def families_phase(torch, root, smi):
    """The four model families this slice ports, at full width: each served
    (engine_serving_phase: 32 utterances at B16 against the CPU engine),
    trained for 2 epochs (family_train_phase: B32 through the
    ExperimentBuilder, a train step against the CPU's, step times and a
    profiled step), and the GRU families and the MoE Transformer served in
    bf16 beside f32 (bf16_engine_case, against the bf16 CPU engine).
    MultiSpeakerF0Model: 1 K3 a batch and step, 1 K4 a step, no MLPG.
    VAEProsodyModel: the decoder's K3 and 1 MLPG a served batch; the
    encoder's and the decoder's K3 and K4 and 1 MLPG a step, both K3 a valid
    batch; its latent-sample analysis (vae_latent_case). ConvAcousticModel:
    no kernel of the JAX package but MLPG, 1 a batch and step; the causal
    configuration streamed (conv_stream_case). The Transformer with
    MOE_KWARGS: 6 attention forwards a batch, 6 of each direction a step, 1
    MLPG. The process's compute dtype is f32 throughout (an earlier bf16
    phase leaves it bf16), bf16 only inside bf16_engine_case's bf16 turns;
    the convolutional phases start from PyTorch's default cuDNN TF32
    (tf32_as_users_get). Returns every counted kernel's launches, each
    phase's counters set to 0 just before it."""
    with compute_dtype(None):
        return _families_phase(torch, root, smi)


def _families_phase(torch, root, smi):
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.models.conv_spss import ConvAcousticModel
    from morgana_tpu_torch.models.multispeaker_f0 import MultiSpeakerF0Model
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
    from morgana_tpu_torch.models.vae_prosody import VAEProsodyModel
    from morgana_tpu_torch.ops import flash_attention as fa
    from morgana_tpu_torch.ops import gru as gru_ops

    moe_label = 'TransformerAcousticModel(moe_experts=8) 609-6x(384, 4 heads, 1536; MoE 2/4/6)-199'
    launches = dict.fromkeys(('k3', 'k4', 'k3c', 'attn_fwd', 'attn_bwd', 'k5b'), 0)
    seconds, start = {}, time.perf_counter()

    def lap(name):
        nonlocal start
        seconds[name] = time.perf_counter() - start
        start = time.perf_counter()

    # Serving, f32.
    launches['k3'] += engine_serving_phase(
        torch, root, MultiSpeakerF0Model, 'multispeaker_serving',
        'MultiSpeakerF0Model 9-256-GRU(64)-1, 4 speakers', speaker_items, {'normalised_lf0': 1},
        gru_ops, 'k3', 1, 120, prepare=write_speaker_normalisers, mlpg_per_batch=0)
    launches['k3'] += engine_serving_phase(
        torch, root, VAEProsodyModel, 'vae_serving', 'VAEProsodyModel z16, GRU(3->64), '
        '625-64-GRU(64)-3, zero latent', make_items, {'normalised_lf0_deltas': 3, 'lf0': 1},
        gru_ops, 'k3', 1, 121)
    with tf32_as_users_get(torch, 'conv_serving'):
        engine_serving_phase(torch, root, ConvAcousticModel, 'conv_serving',
                             'ConvAcousticModel 609-512-6x(conv k5, dilations 1,2,4,8,1,2)-256-199',
                             make_items, ACOUSTIC_DIMS, None, None, 0, 122)
    launches['attn_fwd'] += engine_serving_phase(
        torch, root, TransformerAcousticModel, 'moe_serving', moe_label, make_items,
        ACOUSTIC_DIMS, fa, 'attn_fwd', TRANSFORMER_BLOCKS, 123, model_kwargs=MOE_KWARGS)
    lap('serving')

    # Training.
    trained, _ = family_train_phase(torch, root, 'multispeaker_train', MultiSpeakerF0Model,
                                    gru_ops, ('k3', 'k4'), nn.Recurrent, 1, 124,
                                    corpus=speaker_corpus, mlpg_per_step=0)
    trained_vae, vae_exp = family_train_phase(torch, root, 'vae_train', VAEProsodyModel, gru_ops,
                                              ('k3', 'k4'), nn.Recurrent, 2, 125,
                                              fixed_noise=True)
    latent_k3 = vae_latent_case(torch, vae_exp)
    for got in (trained, trained_vae):
        launches['k3'] += got['k3']
        launches['k4'] += got['k4']
    launches['k3'] += latent_k3
    with tf32_as_users_get(torch, 'conv_train'):
        family_train_phase(torch, root, 'conv_train', ConvAcousticModel, None,
                           ('none', 'none_bwd'), nn.Conv1d, CONV_BLOCKS, 126)
    trained, _ = family_train_phase(torch, root, 'moe_train', TransformerAcousticModel, fa,
                                    ('attn_fwd', 'attn_bwd'), nn.MultiHeadAttention,
                                    TRANSFORMER_BLOCKS, 127, '--learning_rate', TRANSFORMER_LR,
                                    model_kwargs=MOE_KWARGS)
    launches['attn_fwd'] += trained['attn_fwd']
    launches['attn_bwd'] += trained['attn_bwd']
    lap('training')

    with tf32_as_users_get(torch, 'conv_stream'):
        conv_stream_case(torch, root, smi)
    lap('conv_stream')

    # bf16 serving beside f32.
    base = os.path.join(root, 'families_bf16')
    for name, cls, make, dims, ops, attr, layers, label, seed, kwargs, mlpg, prepare in (
            ('multispeaker', MultiSpeakerF0Model, speaker_items, {'normalised_lf0': 1}, gru_ops,
             'bf16_compute_launches', 1, 'MultiSpeakerF0Model 9-256-GRU(64)-1', 140, None, 0,
             write_speaker_normalisers),
            ('vae', VAEProsodyModel, make_items, {'normalised_lf0_deltas': 3, 'lf0': 1}, gru_ops,
             'bf16_compute_launches', 1, 'VAEProsodyModel, zero latent', 141, None, 1, None),
            ('moe', TransformerAcousticModel, make_items, ACOUSTIC_DIMS, fa, 'bf16_launches',
             TRANSFORMER_BLOCKS, moe_label, 142, MOE_KWARGS, 1, None)):
        family_root = os.path.join(base, name)
        os.makedirs(family_root)
        rng = np.random.default_rng(seed)
        ckpt = seeded_checkpoint(torch, cls, os.path.join(family_root, 'epoch_1.npz'), seed,
                                 **(kwargs or {}))
        write_normalisers(family_root, rng)
        if prepare is not None:
            prepare(family_root, rng)
        n, _, _ = bf16_engine_case(torch, name, cls, ckpt, family_root, make(rng), dims, ops,
                                   attr, layers, label, model_kwargs=kwargs, mlpg_per_batch=mlpg)
        launches['k3c' if ops is gru_ops else 'k5b'] += n
    lap('bf16_serving')
    emit({'phase': 'families', 'launches': launches, 'seconds': seconds})
    return launches


# The builder phase's bars. OPT_PARAM_RTOL: the card's and the CPU's
# parameter change over 3 steps, as the relative L2 distance over the whole
# model. The gradients agree to 1.4e-6 of each tensor's largest
# (train_parity); Adam's first update is about sign(g) for every |g| above
# eps, so the coordinates whose gradient lies below that spread may step the
# other way on the card, each by 2 lr: the L2 distance weighs them by their
# number, not by the largest one. SGD's change is linear in the gradient.
OPT_PARAM_RTOL = 1e-2
# Accumulation (SGD, so the change is linear in the gradient): each
# parameter within 2 f32 ulps of its value (the update is rounded into a
# parameter some 1e3-1e4 times larger: on the H100 the change of
# layers.8.w_hh_l0 read 1 ulp in 22 off with gradient norms equal to the
# last digit) plus ACCUM_RTOL of its tensor's largest change, against one
# step on the concatenated batch (f32 sums of 2 x 16 and of 32 items in
# other orders).
ACCUM_RTOL = 1e-4
# --log_norms: the card's three norms against the CPU's, relative.
NORMS_RTOL = 1e-4
BUILDER_BATCH = 16
BUILDER_OPTIMIZERS = (('adamw', '{}'), ('sgd', "{'momentum': 0.9, 'nesterov': True}"),
                      ('lamb', '{}'))
SEARCH_LIMIT_GIB = 8.0
BUILDER_INTERRUPT_AT = 7    # epoch 1's 4 steps, epoch 2's first 2, then the interrupt

BUILDER_RUN = r'''
import json, os, sys
from morgana_tpu_torch import _build
from morgana_tpu_torch.models import rnn_spss
from morgana_tpu_torch.ops import lstm
rnn_spss.main(sys.argv[1:])
print(json.dumps({'nvcc_runs': _build.nvcc_runs, 'build_dir': _build.BUILD_DIR,
                  'libraries': sorted(f for f in os.listdir(_build.BUILD_DIR) if f.endswith('.so')),
                  'k1': lstm.launches, 'k1_gates': lstm.gate_launches,
                  'k2': lstm.bwd_launches}))
'''


def parity_corpus(root):
    """The parity phases' corpus: 4 train utterances of 20-39 phones of 5-7
    frames, written once under `root`."""
    from morgana_tpu_torch.data.synthetic import generate_voice_data

    data_root = os.path.join(root, 'parity_data')
    if not os.path.isdir(data_root):
        generate_voice_data(data_root, num_train=4, num_valid=0, num_test=0, seed=8,
                            n_phones_range=(20, 40), dur_range=(5, 8))
    return data_root


def lstm_builder(data_root, base, name, ckpt, *flags, callbacks=None):
    """An ExperimentBuilder of LSTMAcousticModel at full width on the card
    (the command line's defaults and `flags`)."""
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel

    args = ExperimentBuilder.get_experiment_args(builder_argv(data_root, base, name, ckpt,
                                                              *flags))
    return ExperimentBuilder(LSTMAcousticModel, callbacks=callbacks, **args)


def timed_step(torch, loop, features, lr):
    """One train step, its loss fetched (a sync); returns (loss, ms)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    loss, _ = loop.train_step(features, lr)
    loss = float(loss)
    torch.cuda.synchronize()
    return loss, (time.perf_counter() - start) * 1e3


def optimizer_update_ms(torch, loop, reps=20):
    """The optimiser's update alone (the chain and p -= lr u over every
    parameter, from the last step's gradients) by CUDA events."""
    from morgana_tpu_torch.training import apply_updates

    grads = [p.grad for p in loop.params.values()]
    return cuda_ms(torch, lambda: apply_updates(loop.optimizer, 0., loop.params, loop.opt_state,
                                                None, 1e-12, grads), reps)


def param_change(exp, init):
    return {n: (p.detach().cpu() - init[n]).double() for n, p in exp.model.named_parameters()}


def builder_optimizer_case(torch, data_root, base, ckpt):
    """Three steps of B4 for each optimiser (weight decay 0.01: decoupled for
    adamw and lamb, in the gradient for sgd) on the card and on the CPU, and
    Adam's on the card: losses, the parameter change, ms a step and the
    update's ms alone (CUDA events, after the checks)."""
    out = {}
    for name, kwargs in (('adam', '{}'),) + BUILDER_OPTIMIZERS:
        runs = {}
        for device in ('cuda', 'cpu') if name != 'adam' else ('cuda',):
            exp = lstm_builder(data_root, base, f'opt_{name}_{device}', ckpt, '--device', device,
                               *HOST_PATH, '--batch_size', '4', '--no-valid', '--optimizer', name,
                               '--optimizer_kwargs', kwargs, '--weight_decay', '0.01')
            exp.model.mode = 'train'
            init = {n: p.detach().cpu().clone() for n, p in exp.model.named_parameters()}
            losses, step_ms = [], []
            for _ in range(3):
                features = host_features(next(iter(exp.train_loader)))
                if device == 'cuda':
                    loss, ms = timed_step(torch, exp.loop, features, exp.learning_rate)
                    step_ms.append(ms)
                else:
                    loss = float(exp.loop.train_step(features, exp.learning_rate)[0])
                losses.append(loss)
            runs[device] = (losses, param_change(exp, init), step_ms)
            if device == 'cuda':
                update_ms = optimizer_update_ms(torch, exp.loop)
        entry = {'gpu_losses': runs['cuda'][0], 'ms_per_step': runs['cuda'][2],
                 'median_ms_after_first': float(np.median(runs['cuda'][2][1:])),
                 'update_ms': update_ms}
        if 'cpu' in runs:
            (gpu_losses, gpu_delta, _), (cpu_losses, cpu_delta, _) = runs['cuda'], runs['cpu']
            loss_rel = [abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses)]
            diff = math.sqrt(sum(float(((gpu_delta[n] - d) ** 2).sum())
                                 for n, d in cpu_delta.items()))
            total = math.sqrt(sum(float((d ** 2).sum()) for d in cpu_delta.values()))
            per_tensor = {n: float((gpu_delta[n] - d).norm() / max(float(d.norm()), 1e-30))
                          for n, d in cpu_delta.items()}
            worst = max(per_tensor, key=per_tensor.get)
            lr = float(exp.learning_rate)
            entry.update(cpu_losses=cpu_losses, loss_rel_err=loss_rel,
                         param_change_rel_l2=diff / total, worst_tensor=worst,
                         worst_tensor_rel_l2=per_tensor[worst],
                         max_abs_change_diff_in_lr=max(
                             float((gpu_delta[n] - d).abs().max()) for n, d in
                             cpu_delta.items()) / lr)
            if max(loss_rel) > TRAIN_LOSS_RTOL or diff / total > OPT_PARAM_RTOL:
                raise AssertionError(f'builder optimizer {name}: card against CPU {entry}')
        out[name] = entry
    return out


def lstm_counts():
    from morgana_tpu_torch.ops import lstm as lstm_ops
    return {'k1': lstm_ops.launches, 'k1_gates': lstm_ops.gate_launches,
            'k2': lstm_ops.bwd_launches}


def reset_lstm_counts():
    from morgana_tpu_torch.ops import lstm as lstm_ops
    lstm_ops.launches = lstm_ops.gate_launches = lstm_ops.bwd_launches = 0


def builder_accum_case(torch, data_root, base, ckpt):
    """--grad_accum_steps 2 at B16 against one step of the same 32
    utterances at B32 (SGD), each batch assembled as the card's default
    path assembles it (the device cache's gather and device transform);
    the norms of both; then ms an applied update of each, and --log_norms'
    cost on the B32 step: the steps with and without, in turns, and the
    three norms alone (CUDA events)."""
    from morgana_tpu_torch.training import global_norm

    flags = ('--no-valid', '--optimizer', 'sgd', '--log_norms')
    accum = lstm_builder(data_root, base, 'accum', ckpt, '--batch_size', str(BUILDER_BATCH),
                         '--grad_accum_steps', '2', *flags)
    whole = lstm_builder(data_root, base, 'accum_whole', ckpt, '--batch_size',
                         str(2 * BUILDER_BATCH), *flags)
    cache, post = whole.train_loader.device_cache, whole.train_loader.device_transform
    idxs = whole.train_loader.iter_batch_indices()[0]
    micro = [cache.assemble(idxs[:BUILDER_BATCH], post=post),
             cache.assemble(idxs[BUILDER_BATCH:], post=post)]
    batch = cache.assemble(idxs, post=post)
    for exp in (accum, whole):
        exp.model.mode = 'train'
        exp.model.metrics.reset_state('train')
    init = {n: p.detach().cpu().clone() for n, p in accum.model.named_parameters()}
    lr = accum.learning_rate
    per_micro = []
    for features in micro:
        reset_lstm_counts()
        accum.loop.train_step(features, lr)
        torch.cuda.synchronize()
        per_micro.append(lstm_counts())
    layers = 8
    if any(c != {'k1': layers, 'k1_gates': layers, 'k2': layers} for c in per_micro) \
            or not accum.loop.last_step_applied:
        raise AssertionError(f'builder accumulation: launches {per_micro}')
    whole.loop.train_step(batch, lr)
    got, want = param_change(accum, init), param_change(whole, init)
    final = {n: p.detach().cpu().numpy() for n, p in whole.model.named_parameters()}
    rel = {}
    for n, d in want.items():
        ulps = torch.from_numpy(2 * np.spacing(np.abs(final[n]))).double()
        excess = ((got[n] - d).abs() - ulps).clamp(min=0)
        rel[n] = float(excess.max()) / max(float(d.abs().max()), 1e-30)
    worst = max(rel, key=rel.get)
    norms = {name: (accum.model.metrics['train'][name].result(),
                    whole.model.metrics['train'][name].result())
             for name in ('grad_norm', 'param_norm', 'update_norm')}
    grad_norm_rel = abs(norms['grad_norm'][0] - norms['grad_norm'][1]) / norms['grad_norm'][1]

    cycle_ms, step_ms, norms_on, norms_off = [], [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for features in micro:
            accum.loop.train_step(features, lr)
        torch.cuda.synchronize()
        cycle_ms.append((time.perf_counter() - start) * 1e3)
        step_ms.append(timed_step(torch, whole.loop, batch, lr)[1])
    for _ in range(3):
        for on, times in ((False, norms_off), (True, norms_on)):
            whole.loop.log_norms = on
            times.append(timed_step(torch, whole.loop, batch, lr)[1])
    params = list(whole.loop.params.values())
    grads = [p.grad for p in params]

    def three_norms():
        whole.model.metrics.accumulate('train', grad_norm=global_norm(grads),
                                       param_norm=global_norm(params),
                                       update_norm=lr * global_norm(grads))

    norms_ms = cuda_ms(torch, three_norms, 20)
    out = {'B': BUILDER_BATCH, 'T': int(batch['normalised_counters'].shape[1]),
           'launches_per_micro_batch': per_micro, 'max_change_rel_past_2_ulps': rel[worst],
           'worst_tensor': worst, 'accum_rtol': ACCUM_RTOL, 'norms_accum_vs_whole': norms,
           'grad_norm_rel': grad_norm_rel, 'ms_per_applied_update_accum': cycle_ms,
           'ms_per_applied_update_b32': step_ms, 'ms_b32_log_norms_on': norms_on,
           'ms_b32_log_norms_off': norms_off,
           'log_norms_overhead_ms': float(np.median(norms_on) - np.median(norms_off)),
           'norms_alone_ms': norms_ms}
    if rel[worst] > ACCUM_RTOL or grad_norm_rel > NORMS_RTOL:
        raise AssertionError(f'builder accumulation disagrees with the B32 step: {out}')
    return out


def builder_norms_case(torch, data_root, base, ckpt):
    """--log_norms for one epoch of B4 on the card and on the CPU: the
    three norms in metrics.json, within NORMS_RTOL."""
    metrics = {}
    for device in ('cuda', 'cpu'):
        exp = lstm_builder(data_root, base, f'norms_{device}', ckpt, '--device', device,
                           *HOST_PATH, '--batch_size', '4', '--no-valid', '--end_epoch', '1',
                           '--log_norms')
        exp.run_experiment()
        with open(os.path.join(exp.experiment_dir, 'train', 'epoch_1', 'metrics.json')) as f:
            metrics[device] = json.load(f)
    names = ('grad_norm', 'param_norm', 'update_norm')
    rel = {n: abs(metrics['cuda'][n] - metrics['cpu'][n]) / abs(metrics['cpu'][n]) for n in names}
    out = {'gpu': {n: metrics['cuda'][n] for n in names},
           'cpu': {n: metrics['cpu'][n] for n in names}, 'rel_err': rel, 'rtol': NORMS_RTOL}
    if max(rel.values()) > NORMS_RTOL:
        raise AssertionError(f'builder --log_norms: card against CPU {out}')
    return out


def interrupted(exp, at):
    """Runs `exp` with a KeyboardInterrupt in place of its `at`-th train
    step: the run saves its emergency checkpoint and re-raises."""
    step, calls = exp.loop.train_step, []

    def interrupting(features, lr, force_apply=False):
        calls.append(1)
        if len(calls) == at:
            raise KeyboardInterrupt
        return step(features, lr, force_apply=force_apply)

    exp.loop.train_step = interrupting
    try:
        exp.run_experiment()
    except KeyboardInterrupt:
        return
    raise AssertionError('builder resume: the interrupt did not reach the builder')


def checkpoint_params(exp_dir, name):
    with np.load(os.path.join(exp_dir, 'checkpoints', name)) as f:
        return {k: f[k] for k in f.files}


def params_spread(a, b):
    """Each tensor's max |a - b| over its max |b|, the largest, and where."""
    rel = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max()) / max(
        float(np.abs(b[k]).max()), 1e-30) for k in b}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def lstm_determinism(torch):
    """Which of the LSTM step's kernels repeat bit for bit on the card: K1
    with gates and K2 twice on the same inputs at the resume runs' shape."""
    from morgana_tpu_torch.ops import lstm as lstm_ops

    x, weights, seq_len, h0, c0 = layer_inputs(torch, torch.device('cuda'), BUILDER_BATCH, 1024,
                                               True, 62)
    rng = np.random.default_rng(63)
    loss_weights = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
                    for s in ((BUILDER_BATCH, 1024, H), (BUILDER_BATCH, H), (BUILDER_BATCH, H))]
    runs = [layer_grads(torch, lstm_ops.lstm_layer, x, weights, seq_len, h0, c0, loss_weights)
            for _ in range(2)]
    names = ('dx', 'dw_ih', 'dw_hh', 'db_ih', 'db_hh', 'dh0', 'dc0')
    return {n: bool(torch.equal(a, b)) for n, a, b in zip(names, *runs)}


def builder_resume_case(torch, data_root, base, ckpt, smi):
    """Two uninterrupted runs (bit-reproducible or not), one stopped by an
    interrupt in epoch 2 and finished with --checkpoint_path latest, all at
    B16 for 2 epochs with step checkpoints, length-sorted windows and 4
    loader threads; then the retention left and --config's first loss (the
    epoch seconds with 4 loader threads and with none are fast_path's
    prefetch case, on the same corpus). Returns the numbers and the K1/K2
    launches of the uninterrupted runs."""
    flags = ('--batch_size', str(BUILDER_BATCH), '--no-valid', '--end_epoch', '2',
             '--step_checkpoint_interval', '1', '--length_sort_window', '2',
             '--num_data_threads', '4', '--keep_checkpoints', '1')
    save_s, exps = [], {}
    reset_lstm_counts()
    for name in ('resume_a', 'resume_b'):
        exp = exps[name] = lstm_builder(data_root, base, name, ckpt, *flags)
        save = exp._save_step_checkpoint

        def timed_save(*args, save=save):
            start = time.perf_counter()
            save(*args)
            save_s.append(time.perf_counter() - start)

        exp._save_step_checkpoint = timed_save
        exp.run_experiment()
    torch.cuda.synchronize()
    launches = lstm_counts()
    steps = 2 * 2 * len(exps['resume_a'].train_loader)
    if launches != {'k1': 8 * steps, 'k1_gates': 8 * steps, 'k2': 8 * steps}:
        raise AssertionError(f'builder resume: launches {launches} in {steps} steps')
    a = checkpoint_params(exps['resume_a'].experiment_dir, 'epoch_2.npz')
    b = checkpoint_params(exps['resume_b'].experiment_dir, 'epoch_2.npz')
    spread, spread_at = params_spread(a, b)
    identical = spread == 0.0
    interrupted(lstm_builder(data_root, base, 'resume_c', ckpt, *flags), BUILDER_INTERRUPT_AT)
    resumed = lstm_builder(data_root, base, 'resume_c', 'latest', *flags)
    position = [os.path.basename(resumed.checkpoint_path), resumed.start_epoch,
                resumed._resume_batches_done, resumed.loop.step_count]
    if position != ['step.npz', 2, 2, 6]:
        raise AssertionError(f'builder resume: latest resolved to {position}')
    resumed.run_experiment()
    c = checkpoint_params(resumed.experiment_dir, 'epoch_2.npz')
    resume_err, resume_at = params_spread(c, a)
    left = sorted(f for f in os.listdir(os.path.join(resumed.experiment_dir, 'checkpoints'))
                  if f.startswith('epoch_'))
    out = {'runs_bit_identical': identical, 'run_to_run_spread': spread,
           'spread_tensor': spread_at, 'resume_position': position,
           'resume_vs_uninterrupted': resume_err, 'resume_worst_tensor': resume_at,
           'epoch_files_left': left, 'step_checkpoint_save_s': save_s,
           'step_checkpoint_mib': sum(os.path.getsize(os.path.join(
               exps['resume_a'].experiment_dir, 'checkpoints', f)) for f in
               ('step.npz', 'step.train.pkl')) / 2 ** 20,
           'train_losses_a': exps['resume_a'].train_losses}
    if not identical:
        out['kernels_bit_identical'] = lstm_determinism(torch)
    if left != ['epoch_2.npz', 'epoch_2.train.pkl', 'epoch_2_interrupted.npz',
                'epoch_2_interrupted.train.pkl'] \
            or (resume_err != 0.0 if identical else resume_err > spread):
        raise AssertionError(f'builder resume: {out}')

    replay = lstm_builder(data_root, base, 'replay', ckpt, '--config',
                          os.path.join(exps['resume_a'].experiment_dir, 'config.json'),
                          '--end_epoch', '1', '--step_checkpoint_interval', '0')
    replay.run_experiment()
    first = (replay.train_losses[1][0], exps['resume_a'].train_losses[1][0])
    out['config_first_loss'] = first
    if (first[0] != first[1]) if identical else abs(first[0] - first[1]) > spread * abs(first[1]):
        raise AssertionError(f'builder --config: first loss {first}')

    return out, launches


def builder_find_lr_case(torch, data_root, base, ckpt):
    """--find_lr 1e-5,1,12 at B16: lr_find.json, its steps_run, stop_reason
    and suggestion."""
    exp = lstm_builder(data_root, base, 'find_lr', ckpt, '--batch_size', str(BUILDER_BATCH),
                       '--find_lr', '1e-5,1,12')
    result = exp.run_experiment()
    if not os.path.isfile(os.path.join(exp.experiment_dir, 'lr_find.json')):
        raise AssertionError('builder --find_lr wrote no lr_find.json')
    out = {k: result[k] for k in ('steps_run', 'stop_reason', 'suggestion')}
    out['png'] = os.path.isfile(os.path.join(exp.experiment_dir, 'lr_find.png'))
    return out


def builder_search_case(torch, data_root, base, ckpt):
    """--search_batch_size SEARCH_LIMIT_GIB from the B16 first batch: the
    size found, a step there at or under the limit, and the next size up
    with why it failed (memory, or K1/K2's batch limit)."""
    from morgana_tpu_torch import memory

    exp = lstm_builder(data_root, base, 'search', ckpt, '--batch_size', str(BUILDER_BATCH),
                       '--search_batch_size', str(SEARCH_LIMIT_GIB))
    best = exp.run_experiment()
    with open(os.path.join(exp.experiment_dir, 'batch_size_search.txt')) as f:
        text = f.read()
    limit = int(SEARCH_LIMIT_GIB * 2 ** 30)
    features = host_features(next(iter(exp.train_loader)))
    exp.model.mode = 'train'
    peak = memory.measure_train_step(exp.loop, memory.batch_at(features, best))
    next_line = [line for line in text.splitlines() if line.startswith('Next size')]
    out = {'limit_gib': SEARCH_LIMIT_GIB, 'found': best, 'peak_at_found_mib': peak / 2 ** 20,
           'next_size': next_line, 'T': int(features['normalised_counters'].shape[1]),
           'probes': [line.strip() for line in text.splitlines() if line.startswith('  ')]}
    if best is None or peak > limit or not next_line:
        raise AssertionError(f'builder --search_batch_size: {out}')
    return out


def trace_census(events):
    """The kernels of a chrome trace by kind, a name of each of K1 and K2,
    and the cooperative launches (K1's and K2's runtime calls) whose kernel
    record the tracer lost: for each, the train step whose host range holds
    the call and the call's place among that step's cooperative launches."""
    traced, names = {}, {}
    kernels = set()
    for e in events:
        if e.get('cat') == 'kernel':
            kind = kernel_kind(e['name'])
            traced[kind] = traced.get(kind, 0) + 1
            kernels.add(e.get('args', {}).get('correlation'))
            if kind in ('k1', 'k2'):
                names[kind] = e['name']
    steps = sorted((e['ts'], e['ts'] + e.get('dur', 0), e['name']) for e in events
                   if e.get('cat') == 'user_annotation'
                   and str(e.get('name', '')).startswith('train step'))
    launches = sorted((e['ts'], e.get('args', {}).get('correlation')) for e in events
                      if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                      and 'LaunchCooperativeKernel' in str(e.get('name', '')))
    lost, place = [], {}
    for ts, correlation in launches:
        step = next((name for start, end, name in steps if start <= ts <= end), None)
        place[step] = place.get(step, -1) + 1
        if correlation not in kernels:
            lost.append({'step': step, 'cooperative_launch': place[step]})
    return traced, names, len(launches), lost


def builder_report_case(torch, data_root, base, ckpt, attempts=3):
    """One epoch at B16 with validation, --memory_report and --profile_dir,
    each in a fresh process as a user runs the builder: the report's peak,
    K1 and K2 in the trace (8 of each a step, by the names the profiler
    gives them, each counted by its wrapper), metrics.pdf or why it was not
    written. In this script's own process, after its earlier phases, the
    tracer has lost the kernel record of an epoch's first K1 (its launch
    record there) in every trace of a run; a fresh process had never lost
    one. A trace short of a kernel is still taken again, in a new process,
    up to `attempts` in all; every short one is reported with the launches
    it lost (`trace_census`)."""
    from morgana_tpu_torch.viz import plotting

    with open(os.path.join(data_root, 'train', 'train_file_id_list.scp')) as f:
        steps = math.ceil(sum(1 for line in f if line.strip()) / BUILDER_BATCH)
    short = []
    for attempt in range(attempts):
        name, profile_dir = f'report_{attempt}', os.path.join(base, f'profile_{attempt}')
        counted = run_script(f'builder --profile_dir run {attempt}', BUILDER_RUN,
                             *builder_argv(data_root, base, name, ckpt),
                             '--batch_size', str(BUILDER_BATCH), '--end_epoch', '1',
                             '--memory_report', '--profile_dir', profile_dir)
        with open(os.path.join(profile_dir, 'train_epoch_1.pt.trace.json')) as f:
            events = json.load(f)['traceEvents']
        traced, names, cooperative, lost = trace_census(events)
        trace = {'trace_k1': traced.get('k1', 0), 'trace_k2': traced.get('k2', 0),
                 'trace_kernel_names': names, 'trace_cooperative_launches': cooperative,
                 'trace_lost': lost, 'steps': steps,
                 'launches': {k: counted[k] for k in ('k1', 'k1_gates', 'k2')}}
        # The trace covers the first epoch's training, which ends before its
        # validation: 8 K1 with gates and 8 K2 a step.
        if counted['k1_gates'] != 8 * steps or counted['k2'] != 8 * steps:
            raise AssertionError(f'builder --profile_dir: the wrappers counted {trace}')
        if trace['trace_k1'] == trace['trace_k2'] == 8 * steps:
            break
        short.append(trace)
    experiment_dir = os.path.join(base, name)
    with open(os.path.join(experiment_dir, 'memory_report.txt')) as f:
        report = [line.strip() for line in f]
    wrote_pdf = os.path.isfile(os.path.join(experiment_dir, 'metrics.pdf'))
    out = {'memory_report': [line for line in report if line.startswith(('peak:', 'parameters:',
                                                                         'step_peak'))],
           **trace, 'short_traces': short,
           'trace_step_ranges': sum(1 for e in events
                                    if str(e.get('name', '')).startswith('train step')),
           'metrics_pdf': wrote_pdf if plotting.matplotlib_available()
           else 'not written: matplotlib is not installed'}
    if not any(line.startswith('peak:') for line in report) or trace['trace_k1'] != 8 * steps \
            or trace['trace_k2'] != 8 * steps or wrote_pdf != plotting.matplotlib_available():
        raise AssertionError(f'builder --memory_report/--profile_dir: {out}')
    return out


def builder_nans_case(torch, parity_root, base, ckpt):
    """--debug_nans with a NaN written into the third LSTM layer's w_hh:
    FloatingPointError naming that layer."""
    exp = lstm_builder(parity_root, base, 'nans', ckpt, '--batch_size', '4', '--no-valid',
                       '--end_epoch', '1', '--debug_nans')
    with torch.no_grad():
        dict(exp.model.named_parameters())['layers.5.w_hh_l0'][7, 11] = float('nan')
    try:
        exp.run_experiment()
    except FloatingPointError as exc:
        message = str(exc)
    else:
        message = ''
    if 'module layers.5 (Recurrent)' not in message:
        raise AssertionError(f'builder --debug_nans: {message!r}')
    return {'error': message}


def builder_cache_case(torch, parity_root, base, ckpt, root):
    """--compilation_cache_dir: the builder (one epoch of B4) twice, each a
    fresh process, in the directory compilation_cache left (a new one when
    that phase did not run): K1's, K2's and MLPG's libraries are there after
    the first, and the second runs no nvcc."""
    cache = os.path.join(root, 'kernel_cache')
    before = sorted(os.listdir(cache)) if os.path.isdir(cache) else []
    runs = [run_script(f'builder compilation_cache run {i}', BUILDER_RUN,
                       *builder_argv(parity_root, base, f'cache_{i}', ckpt),
                       '--batch_size', '4', '--no-valid', '--end_epoch', '1',
                       '--compilation_cache_dir', cache) for i in range(2)]
    libraries = sorted({f.split('.')[0] for f in runs[0]['libraries']}
                       & {'lstm_fwd', 'lstm_bwd', 'mlpg'})
    out = {'files_before': before, 'runs': runs, 'libraries': libraries}
    if len(libraries) != 3 or runs[1]['nvcc_runs'] or not runs[0]['k2'] or not runs[1]['k2']:
        raise AssertionError(f'builder --compilation_cache_dir: {out}')
    return out


def builder_phase(torch, root, smi):
    """The rest of the voice builder's training loop on the card (phase 27 of
    the module docstring): builder_<case> lines, then the builder line.
    Returns the K1 and K2 launches of its main path (the resume runs)."""
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel

    data_root, _ = train_corpus(root)
    parity_root = parity_corpus(root)
    ckpt = seeded_checkpoint(torch, LSTMAcousticModel,
                             os.path.join(root, 'builder_init', 'epoch_0.npz'), 61)
    base = os.path.join(root, 'builder_experiments')
    start = time.perf_counter()
    cases = {}
    for name, case in (
            ('optimizers', lambda: builder_optimizer_case(torch, parity_root, base, ckpt)),
            ('accumulation', lambda: builder_accum_case(torch, data_root, base, ckpt)),
            ('log_norms', lambda: builder_norms_case(torch, parity_root, base, ckpt)),
            ('resume', lambda: builder_resume_case(torch, data_root, base, ckpt, smi)),
            ('find_lr', lambda: builder_find_lr_case(torch, data_root, base, ckpt)),
            ('search', lambda: builder_search_case(torch, data_root, base, ckpt)),
            ('report', lambda: builder_report_case(torch, data_root, base, ckpt)),
            ('debug_nans', lambda: builder_nans_case(torch, parity_root, base, ckpt)),
            ('compilation_cache', lambda: builder_cache_case(torch, parity_root, base, ckpt,
                                                             root))):
        case_start = time.perf_counter()
        cases[name] = case()
        if name == 'resume':
            cases[name], launches = cases[name]
        emit({'phase': f'builder_{name}', 'card': smi,
              'seconds': time.perf_counter() - case_start, **cases[name]})
    emit({'phase': 'builder', 'card': smi, 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
          'seconds': time.perf_counter() - start, 'launches': launches})
    return launches
# ------------------------------------------------------------ fast path

FAST_PATH_SPD = 8           # --steps_per_dispatch of the fast_path phase's chains
FAST_PATH_BATCHES = 8       # B32 train batches an epoch: each epoch one chain of 8
FAST_PATH_PHONES = 60       # phones an utterance, 5 frames each: every batch of one shape
FAST_ULPS = 2               # device-normalised keys against the host path's (JAX's claim)
PREFETCH_THREADS = (0, 4)
FAST_TIMING_KEYS = ('epoch_duration_s', 'ms_per_step', 'frames_per_sec')
FAST_BF16_COUNTERS = {'k1c_cluster': 'bf16_cluster_launches',
                      'k1c_cluster_gates': 'bf16_cluster_gate_launches',
                      'k2c_cluster': 'bf16_cluster_bwd_launches'}

FAST_PATH_RUN = r'''
import itertools, json, sys, time
import numpy as np
import torch
import chip_smoke as smoke
from torch.profiler import ProfilerActivity, profile, schedule
from morgana_tpu_torch import data
from morgana_tpu_torch.models.duration_model import DurationModel
from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel

data_root, base, lstm_ckpt, dur_ckpt, spd = sys.argv[1:6]
spd = int(spd)


def traced(fn):
    """One profiled call of fn after a traced warm-up call: wall ms, device
    busy ms and the kernels by kind (chip_smoke.kernel_kind)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(smoke.PROFILE_MARGIN_S)
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        time.sleep(smoke.PROFILE_MARGIN_S)
        prof.step()
    kinds, busy_us = {}, 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, 'is_user_annotation', False) or e.name.startswith('ProfilerStep'):
            continue
        kind = smoke.kernel_kind(e.name)
        kinds[kind] = kinds.get(kind, 0) + 1
        busy_us += e.self_device_time_total
    return wall_ms, busy_us / 1e3, kinds


def timed(fn, repeats=3):
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - start) * 1e3)
    return out


results = {}
for label, model_class, ckpt, flags in (('lstm', LSTMAcousticModel, lstm_ckpt, []),
                                        ('lstm_bf16', LSTMAcousticModel, lstm_ckpt,
                                         ['--compute_dtype', 'bfloat16']),
                                        ('duration', DurationModel, dur_ckpt, []),
                                        ('duration_bf16', DurationModel, dur_ckpt,
                                         ['--compute_dtype', 'bfloat16'])):
    host = smoke.fast_builder(model_class, data_root, base, f'{label}_host', ckpt,
                              *smoke.HOST_PATH, *flags)
    fast = smoke.fast_builder(model_class, data_root, base, f'{label}_fast', ckpt, *flags)
    for exp in (host, fast):
        exp.model.mode = 'train'
        exp.model.metrics.reset_state('train')
    lr = fast.learning_rate
    host_batches = list(itertools.islice(host.train_loader.data_loader, smoke.FAST_PATH_BATCHES))
    cache, post = fast.train_loader.device_cache, fast.train_loader.device_transform
    order = fast.train_loader.iter_batch_indices()[:smoke.FAST_PATH_BATCHES]
    idx_mat = np.stack(order)
    n = len(order)

    def per_batch():
        for features in host_batches:
            host.loop.train_step(features, lr)

    def cached():
        for idxs in order:
            fast.loop.train_step(cache.assemble(idxs, post=post), lr)

    def graphs():
        fast.loop.train_chain(cache, idx_mat, [lr] * n, post=post)

    entry = {}
    for mode, fn, loop in (('per_batch_eager', per_batch, host.loop),
                           ('cache_eager', cached, fast.loop),
                           (f'graphs_spd{spd}', graphs, fast.loop)):
        fn()   # warm-up; graphs: the uncaptured step and the capture
        ms = timed(fn)
        wall, busy, kinds = traced(fn)
        entry[mode] = {'ms_per_step': [m / n for m in ms],
                       'profiled_ms_per_step': wall / n, 'busy_ms_per_step': busy / n,
                       'idle_share': 1 - busy / wall,
                       'kernels_per_step': {k: v / n for k, v in sorted(kinds.items())}}
    graphs_state = fast.loop._graphs
    entry['graphs_captured'] = graphs_state.captures
    entry['capture_seconds'] = graphs_state.capture_seconds
    entry['B'] = int(idx_mat.shape[1])
    entry['padded_T'] = cache.padded_lengths(order[0])
    results[label] = entry
print(json.dumps(results))
'''


def fast_path_corpus(root):
    """The fast_path phase's corpus: FAST_PATH_BATCHES batches of B32 of
    training utterances and one of validation ones, every utterance
    FAST_PATH_PHONES phones of 5 frames (300 frames), so that every batch has
    one shape signature and an epoch is one chain."""
    from morgana_tpu_torch.data.synthetic import generate_voice_data

    data_root = os.path.join(root, 'fast_data')
    if not os.path.isdir(data_root):
        generate_voice_data(data_root, num_train=FAST_PATH_BATCHES * TRAIN_BATCH,
                            num_valid=TRAIN_BATCH, num_test=0, seed=93,
                            n_phones_range=(FAST_PATH_PHONES, FAST_PATH_PHONES + 1),
                            dur_range=(5, 6))
    return data_root


def fast_builder(model_class, data_root, base, name, ckpt, *flags):
    """An ExperimentBuilder on the card with the command line's defaults
    (the card's: the device cache and device-side normalisation) and
    `flags`."""
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder

    args = ExperimentBuilder.get_experiment_args([
        '--experiment_name', name, '--experiments_base', base, '--data_root', data_root,
        '--train_id_list', 'train/train_file_id_list.scp',
        '--valid_id_list', 'valid/valid_file_id_list.scp', '--checkpoint_path', ckpt, *flags])
    return ExperimentBuilder(model_class, **args)


def ulps(torch, got, want):
    """The largest distance in float32 ulps between two float32 tensors (the
    floats' bit patterns as ordered integers)."""
    def ordered(t):
        bits = t.float().contiguous().view(torch.int32).long()
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)

    return int((ordered(got) - ordered(want)).abs().max()) if got.numel() else 0


def fast_batches_case(torch, exp, host_exp, batches=2):
    """The device path's batches against the host path's on the first
    `batches` batches of an epoch: the cache's gather (no transform) bit for
    bit against the collated items of its own dataset on the card; with the
    device transform, raw and delta keys bit for bit and normalised keys
    within FAST_ULPS of the host path's collated batch."""
    from morgana_tpu_torch import data

    cache, post = exp.train_loader.device_cache, exp.train_loader.device_transform
    dataset, host_dataset = exp.train_loader.dataset, host_exp.train_loader.dataset
    worst_ulps, keys, bit_keys = 0, set(), set()
    for idxs in exp.train_loader.iter_batch_indices()[:batches]:
        items = [int(i) for i in idxs]
        gathered = cache.assemble(idxs)
        collated = data.device_features(dataset.collate_fn([dataset[i] for i in items]),
                                        exp.device)
        for key, value in collated.items():
            if key not in gathered or not torch.equal(gathered[key], value) \
                    or gathered[key].dtype != value.dtype:
                raise AssertionError(f'fast_path: the cache gathered {key} unlike collate')
        normalised = cache.assemble(idxs, post=post)
        host = data.device_features(host_dataset.collate_fn([host_dataset[i] for i in items]),
                                    exp.device)
        for key, want in host.items():
            got = normalised.get(key)
            if got is None or got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f'fast_path: device-normalised {key} missing or misshapen')
            keys.add(key)
            if key.startswith('normalised_'):
                worst_ulps = max(worst_ulps, ulps(torch, got, want))
            else:
                bit_keys.add(key)
                if not torch.equal(got, want):
                    raise AssertionError(f'fast_path: device-side {key} differs from the host '
                                         'path')
    out = {'batches': batches, 'keys': sorted(keys), 'bitwise_keys': sorted(bit_keys),
           'normalised_max_ulps': worst_ulps, 'ulps_bound': FAST_ULPS}
    if worst_ulps > FAST_ULPS:
        raise AssertionError(f'fast_path: device-normalised keys: {out}')
    return out


def wire_bytes_case(exp, host_exp):
    """Bytes a B32 batch moves to the card: the host path's collated batch,
    --device_normalise's (raw streams and lengths), the same on a bf16
    wire, and the cache's index vector."""
    import torch
    from morgana_tpu_torch.data.device_normalise import make_device_transform

    dataset, host_dataset = exp.train_loader.dataset, host_exp.train_loader.dataset
    idxs = [int(i) for i in exp.train_loader.iter_batch_indices()[0]]

    def numeric_bytes(batch, wire=None, keep=()):
        total = 0
        for key, value in batch.items():
            if isinstance(value, np.ndarray) and value.dtype.kind in 'fiub':
                lossy = wire is not None and value.dtype == np.float32 and value.ndim >= 3 \
                    and key not in keep
                total += value.size * 2 if lossy else value.nbytes
        return total

    raw = dataset.collate_fn([dataset[i] for i in idxs])
    transform, _ = make_device_transform(dataset.data_sources, dataset.normalisers,
                                         names=dataset.device_names, wire_dtype=torch.bfloat16)
    return {'B': len(idxs), 'host_path': numeric_bytes(host_dataset.collate_fn(
                [host_dataset[i] for i in idxs])),
            'device_normalise': numeric_bytes(raw),
            'device_normalise_bf16_wire': numeric_bytes(transform.pre_put(raw), 'bf16',
                                                        transform.keep_f32),
            'device_cache': len(idxs) * np.dtype(np.int64).itemsize}


def chain_identity_case(torch, model_class, data_root, base, ckpt, label, *flags):
    """Two epochs with validation at --steps_per_dispatch FAST_PATH_SPD (CUDA
    graph replays) and at 1 (the eager per-batch loop), both on the device
    cache: per-batch losses, the parameters and every metric of each
    epoch's metrics.json bit for bit."""
    runs = {}
    for spd in (FAST_PATH_SPD, 1):
        exp = fast_builder(model_class, data_root, base, f'{label}_spd{spd}', ckpt,
                           '--device_cache', '--steps_per_dispatch', str(spd),
                           '--end_epoch', '2', '--valid_output_interval', '100', *flags)
        start = time.perf_counter()
        exp.run_experiment()
        metrics = {}
        for split in ('train', 'valid'):
            for epoch in (1, 2):
                with open(os.path.join(exp.experiment_dir, split, f'epoch_{epoch}',
                                       'metrics.json')) as f:
                    metrics[split, epoch] = json.load(f)
        graphs = exp.loop._graphs
        runs[spd] = {'losses': exp.train_losses, 'metrics': metrics,
                     'params': {k: v.detach().clone() for k, v in exp.model.named_parameters()},
                     'seconds': time.perf_counter() - start,
                     'captures': graphs.captures if graphs is not None else 0,
                     'capture_seconds': graphs.capture_seconds if graphs is not None else 0.0}
    chained, eager = runs[FAST_PATH_SPD], runs[1]
    same_metrics = all({k: v for k, v in chained['metrics'][key].items()
                        if k not in FAST_TIMING_KEYS}
                       == {k: v for k, v in eager['metrics'][key].items()
                           if k not in FAST_TIMING_KEYS} for key in eager['metrics'])
    same_params = all(torch.equal(chained['params'][k], v) for k, v in eager['params'].items())
    out = {'losses_identical': chained['losses'] == eager['losses'],
           'params_identical': same_params, 'metrics_identical': same_metrics,
           'train_losses': chained['losses'], 'graphs_captured': chained['captures'],
           'capture_seconds': chained['capture_seconds'],
           'run_seconds': {'spd8': chained['seconds'], 'spd1': eager['seconds']},
           'ms_per_step': {f'spd{spd}': [runs[spd]['metrics']['train', e]['ms_per_step']
                                         for e in (1, 2)] for spd in runs}}
    if not (out['losses_identical'] and same_params and same_metrics):
        raise AssertionError(f'fast_path {label}: graph replays differ from the eager loop: '
                             f'{out}')
    return out


def remat_case(torch, exp, label):
    """One train step's gradient with and without --remat (every layer or
    block checkpointed) on the same batch and weights: bit for bit, and the
    step's peak memory above what was allocated before it."""
    from morgana_tpu_torch import data, nn
    from morgana_tpu_torch.ops import lstm as lstm_ops

    model = exp.model
    model.mode = 'train'
    batch = exp.loop._batch(data.host_features(next(iter(exp.train_loader))))
    params = list(model.parameters())
    grads, peaks, counts = {}, {}, {}
    for remat in (False, True, False, True):
        nn.set_default_remat(remat)
        model.train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        launches = (lstm_ops.launches, lstm_ops.gate_launches)
        with nn.collect_aux_losses():
            loss, _ = model(batch)
        got = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
        counts[remat] = (lstm_ops.launches - launches[0], lstm_ops.gate_launches - launches[1])
        grads[remat] = [None if g is None else g.detach().clone() for g in got]
        del got, loss
    nn.set_default_remat(False)
    model.metrics.reset_state('train')
    same = all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(grads[False], grads[True]))
    out = {'gradients_identical': same, 'peak_mib': {'remat': peaks[True], 'no_remat':
                                                     peaks[False]},
           'k1_launches_a_step': {'remat': counts[True], 'no_remat': counts[False]}}
    if not same or peaks[True] >= peaks[False]:
        raise AssertionError(f'fast_path remat {label}: {out}')
    return out


def prefetch_case(torch, data_root, base, ckpt):
    """LSTM epochs at B16 on the host data path over the training phases'
    corpus (64 utterances of about 200-1070 frames), the loader's batches
    taken through the prefetch
    (ToDeviceWrapper: pinned copies on a side stream, 2 batches ahead) or
    without it (each batch copied in its step), at 0 and 4 loader threads,
    in turns: epoch seconds."""
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel

    out = {}
    exps = {threads: fast_builder(LSTMAcousticModel, data_root, base, f'prefetch_{threads}', ckpt,
                                  *HOST_PATH, '--batch_size', '16', '--num_data_threads',
                                  str(threads)) for threads in PREFETCH_THREADS}
    for _ in range(2):
        for threads, exp in exps.items():
            exp.model.mode = 'train'
            for label, loader in (('prefetch', exp.train_loader),
                                  ('no_prefetch', exp.train_loader.data_loader)):
                torch.cuda.synchronize()
                start = time.perf_counter()
                for features in loader:
                    exp.loop.train_step(features, exp.learning_rate)
                torch.cuda.synchronize()
                out.setdefault(f'{label}_threads{threads}', []).append(time.perf_counter()
                                                                        - start)
    return out


def fast_path_phase(torch, root, smi):
    """The builder's device-side fast path on the card (the fast_path phase
    of the module docstring). Returns the launches of its main-path runs
    (every counter set to 0 just before them)."""
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.data import native_io
    from morgana_tpu_torch.experiment_builder import CHAIN_RTT_MS
    from morgana_tpu_torch.models.duration_model import DurationModel
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
    from morgana_tpu_torch.ops import gru as gru_ops
    from morgana_tpu_torch.ops import lstm as lstm_ops

    start = time.perf_counter()
    data_root = fast_path_corpus(root)
    base = os.path.join(root, 'fast_experiments')
    lstm_ckpt = seeded_checkpoint(torch, LSTMAcousticModel,
                                  os.path.join(root, 'fast_init', 'lstm', 'epoch_0.npz'), 91)
    dur_ckpt = seeded_checkpoint(torch, DurationModel,
                                 os.path.join(root, 'fast_init', 'duration', 'epoch_0.npz'), 92)
    out = {'corpus_seconds': time.perf_counter() - start}

    # The card's defaults, the probe, the native reader; then one epoch of
    # the main path as a user runs it.
    auto = fast_builder(LSTMAcousticModel, data_root, base, 'auto', lstm_ckpt, '--end_epoch', '1')
    loader = auto.train_loader
    out['auto'] = {'device_cache': auto.device_cache, 'device_normalise': auto.device_normalise,
                   'steps_per_dispatch': auto.steps_per_dispatch,
                   'dispatch_rtt_ms': auto.dispatch_rtt_ms, 'rtt_bound_ms': CHAIN_RTT_MS,
                   'cache': loader.device_cache.describe() if loader.device_cache else None,
                   'device_transform': loader.device_transform is not None,
                   'native_reader': native_io.native_available(),
                   'native_preload': loader.dataset.supports_native_preload}
    if not (auto.device_cache and auto.device_normalise and auto.steps_per_dispatch == 1
            and auto.dispatch_rtt_ms is not None and auto.dispatch_rtt_ms < CHAIN_RTT_MS
            and loader.device_cache is not None and loader.device_transform is not None
            and out['auto']['native_reader'] and out['auto']['native_preload']):
        raise AssertionError(f'fast_path: the card\'s defaults: {out["auto"]}')
    host = fast_builder(LSTMAcousticModel, data_root, base, 'host', lstm_ckpt, *HOST_PATH)
    out['batches'] = fast_batches_case(torch, auto, host)
    out['wire_bytes_a_batch'] = wire_bytes_case(auto, host)
    reset_lstm_counts()
    gru_ops.launches = gru_ops.bwd_launches = 0
    auto.run_experiment()

    # Graph replays against the eager loop, LSTM then Duration.
    out['chain_lstm'] = chain_identity_case(torch, LSTMAcousticModel, data_root, base,
                                            lstm_ckpt, 'chain_lstm')
    out['chain_duration'] = chain_identity_case(torch, DurationModel, data_root, base, dur_ckpt,
                                                'chain_duration')
    launches = dict(lstm_counts(), k3=gru_ops.launches, k4=gru_ops.bwd_launches)
    # The bf16 LSTM's cluster launches (K1c, K2c) captured as such; counted
    # apart, on the bf16 kernels' rows.
    before = {key: getattr(lstm_ops, name) for key, name in FAST_BF16_COUNTERS.items()}
    out['chain_lstm_bf16'] = chain_identity_case(torch, LSTMAcousticModel, data_root, base,
                                                 lstm_ckpt, 'chain_lstm_bf16', '--compute_dtype',
                                                 'bfloat16')
    launches.update({key: getattr(lstm_ops, name) - before[key]
                     for key, name in FAST_BF16_COUNTERS.items()})
    nn.set_default_compute_dtype(None)   # a builder sets the process's; f32 from here

    # The profiler's census of a replayed step, and the step times of the
    # three routes, in a fresh process.
    timing = run_script('fast_path timing', FAST_PATH_RUN, data_root,
                        os.path.join(root, 'fast_timing'), lstm_ckpt, dur_ckpt,
                        str(FAST_PATH_SPD), timeout=900)
    out['timing'] = timing
    graphs = f'graphs_spd{FAST_PATH_SPD}'
    census = {label: timing[label][graphs]['kernels_per_step'] for label in timing}
    want = {'lstm': {'k1': 8, 'k2': 8}, 'lstm_bf16': {'k1c': 8, 'k2c': 8},
            'duration': {'k3': 1, 'k4': 1}, 'duration_bf16': {'k3c': 1, 'k4c': 1}}
    out['replayed_step_kernels'] = {label: {k: census[label].get(k, 0) for k in kinds}
                                    for label, kinds in want.items()}
    if out['replayed_step_kernels'] != want:
        raise AssertionError(f'fast_path: kernels of a replayed step {census}, expected {want}')

    # --remat: the LSTM's and the Transformer's gradients and peaks.
    out['remat_lstm'] = remat_case(torch, host, 'lstm')
    tf_ckpt = seeded_checkpoint(torch, TransformerAcousticModel,
                                os.path.join(root, 'fast_init', 'transformer', 'epoch_0.npz'), 94)
    out['remat_transformer'] = remat_case(torch, fast_builder(
        TransformerAcousticModel, data_root, base, 'remat_transformer', tf_ckpt, *HOST_PATH,
        '--learning_rate', TRANSFORMER_LR), 'transformer')
    out['prefetch_epoch_s'] = prefetch_case(torch, train_corpus(root)[0], base, lstm_ckpt)
    emit({'phase': 'fast_path', 'card': smi, 'seconds': time.perf_counter() - start,
          'launches': launches, **out})
    if not all(launches[k] for k in ('k1_gates', 'k2', 'k3', 'k4', 'k1c_cluster_gates',
                                     'k2c_cluster')):
        raise AssertionError(f'fast_path: a kernel of the main path was not launched: {launches}')
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser(description='Smoke test of the port on one NVIDIA GPU; '
                                     'with no arguments, every phase.')
    parser.add_argument('--kernel-parent', metavar='DIR',
                        help='only time the attention kernels (K5b too, and the bf16 Transformer '
                        "with DIR's K5b), the bf16 carry, MLPG and the bf16 LSTM and GRU kernels "
                        'of DIR (a tree holding morgana_tpu_torch/csrc, e.g. a git archive of the '
                        "parent commit) beside this tree's, in turns, and stop")
    parser.add_argument('--transformer-only', action='store_true',
                        help='only the Transformer serving and training phases (copied into '
                        "another tree's root, this gives that tree's end-to-end numbers)")
    parser.add_argument('--families-only', action='store_true',
                        help='only the phases of the multi-speaker, VAE, convolutional and '
                        'mixture-of-experts models (families_phase)')
    parser.add_argument('--builder-only', action='store_true',
                        help="only the phase of the voice builder's training loop "
                        '(builder_phase)')
    parser.add_argument('--fast-path-only', action='store_true',
                        help="only the phase of the builder's device-side fast path "
                        '(fast_path_phase)')
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
    # For the library yardsticks (cuDNN's LSTM and GRU), so that they compute
    # the same f32 function; the port turns TF32 off itself, which the
    # convolutional phases check (tf32_as_users_get).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({'phase': 'device', 'nvidia_smi': smi, 'name': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'python': sys.version.split()[0],
          'tf32_matmul': False, 'tf32_cudnn': False})

    # Every kernel, and the LSTM kernels' step_split build, one nvcc each, all
    # started together.
    start = time.perf_counter()
    only = (args.kernel_parent or args.transformer_only or args.families_only or args.builder_only
            or args.fast_path_only)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        split_build = None if only else pool.submit(
            _build.build, ['lstm_fwd', 'lstm_bwd', 'lstm_fwd_bf16', 'lstm_bwd_bf16', 'gru_fwd_bf16',
                           'gru_bwd_bf16'], 'step_split')
        paths = _build.build(None if not only or args.families_only or args.builder_only
                             or args.fast_path_only else ['attn_fwd', 'attn_bwd'] + (
            ['attn_fwd_bf16', 'attn_bwd_bf16', 'rnn_dw_bf16', 'mlpg', 'lstm_fwd_bf16',
             'lstm_bwd_bf16', 'gru_fwd_bf16', 'gru_bwd_bf16']
            if args.kernel_parent else []))
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
        if args.kernel_parent:
            kernel_parent_phase(torch, dev, args.kernel_parent)
        elif args.families_only:
            with tempfile.TemporaryDirectory() as root:
                families_phase(torch, root, smi)
        elif args.builder_only:
            with tempfile.TemporaryDirectory() as root:
                builder_phase(torch, root, smi)
        elif args.fast_path_only:
            with tempfile.TemporaryDirectory() as root:
                fast_path_phase(torch, root, smi)
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
    gru_bf16_step_split_phase(torch, dev)

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

    # MLPG's solve against its plain loop at the serving batch's shapes: the
    # LSTM's three streams (66 static features) and F0Model's one. Their
    # failed checks make the script fail at its end, after every phase.
    mlpg_shape = mlpg_case(torch, dev, 'lstm', SERVE_BATCH, MLPG_FEATS['lstm'], 71)
    mlpg_failures = (mlpg_shape['failures']
                     + mlpg_case(torch, dev, 'f0', SERVE_BATCH, MLPG_FEATS['f0'], 72)['failures'])

    # The bf16-compute kernels K1c, K3c and K5b against their plain versions,
    # then the backward ones of bf16 training.
    bf16_shapes = bf16_kernels_phase(torch, dev)
    bf16_bwd_shapes = bf16_backward_phase(torch, dev)
    lstm_wide_gradient_phase(torch, dev)

    from morgana_tpu_torch.ops import mlpg as mlpg_ops
    mlpg_ops.launches = mlpg_ops.fused_launches = 0
    with tempfile.TemporaryDirectory() as root:
        serve_launches, _, served = serving_phase(torch, root)
        vocoder_batch_phase(torch, dev, served, smi)
        generate_launches = generate_lstm_phase(torch, served, smi)
        pipeline_launches = pipeline_lstm_phase(torch, dev, served, smi)
        stream_launches = stream_lstm_phase(torch, dev, served, smi)
        stream_attn_launches = stream_transformer_phase(torch, dev, served, smi)
        http_launches = http_serve_phase(torch, served, smi)
        quantize_launches = quantize_serve_phase(torch, served, smi)
        export_launches = export_phase(torch, served, smi)
        compilation_cache_phase(torch, served, smi)
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
        bf16_launches = bf16_serving_phase(torch, served, smi)
        bf16_train = bf16_training_phase(torch, root, smi)
        wide = bf16_wide_lstm_phase(torch, root, served, smi)
        families = families_phase(torch, root, smi)
        builder = builder_phase(torch, root, smi)
        fast = fast_path_phase(torch, root, smi)
        for key in FAST_BF16_COUNTERS:
            bf16_train[key] += fast[key]
    mlpg_launches = mlpg_ops.launches + export_launches['mlpg_solve']
    fused_launches = mlpg_ops.fused_launches + export_launches['mlpg']
    if not (serve_launches and generate_launches and test_launches and mlpg_launches
            and fused_launches
            and export_launches['k1'] and export_launches['k3'] and export_launches['attn_fwd']
            and pipeline_launches['k1'] and pipeline_launches['k3'] and stream_launches['k1']
            and stream_launches['k3'] and stream_attn_launches and http_launches['k1']
            and http_launches['k3'] and http_launches['attn'] and quantize_launches
            and train_launches['k1_gates'] and train_launches['k2']
            and bf16_serve_launches and bf16_train_launches['k1_bf16']
            and bf16_train_launches['k2_bf16']
            and f0_serve_launches and f0_train_launches['k3'] and f0_train_launches['k4']
            and duration_launches['k3'] and duration_launches['k4']
            and attn_serve_launches and attn_train_launches['attn_fwd']
            and attn_train_launches['attn_bwd'] and bf16_launches['k1c']
            and bf16_launches['k3c'] and bf16_launches['k5b'] and bf16_train['k1c_gates']
            and bf16_train['k2c'] and bf16_train['k4c'] and bf16_train['k5b_bwd']
            and bf16_train['carry'] and bf16_train['k1c_cluster']
            and bf16_train['k1c_cluster_gates'] and bf16_train['k2c_cluster'] and wide['k1c']
            and wide['k1c_gates'] and wide['k2c'] and all(families.values())
            and builder['k1_gates'] and builder['k2'] and fast['k1_gates'] and fast['k2']
            and fast['k3'] and fast['k4']):
        raise AssertionError('a kernel of the main path was not launched')

    # launches: the main paths' runs, each counted from 0: serving,
    # generation (generate_lstm, builder_test, pipeline_lstm's two routes),
    # the streams of stream_lstm and training for the LSTM kernels; F0Model
    # serving and training, DurationModel training and the duration stage of
    # pipeline_lstm and stream_lstm for the GRU kernels;
    # TransformerAcousticModel serving and training and stream_transformer's
    # batch for the attention kernels; and http_serve's requests (K1, K3 and
    # the attention forward), quantize_serve's batches (K1), and export's
    # loaded programs (K1, K3, the attention forward, in their own process);
    # MLPG's over every one of these paths (mlpg: the whole op, one launch a
    # batch; mlpg_solve: both ops, whose device code is the same, the solve
    # alone launched on none of them); bf16_serving's engines,
    # streams, bundle process and pipeline command line for K1c, K3c and
    # K5b; bf16_training's four models for K1c (with and without its gate
    # trace), K2c, K3c, K4c, K5b and its backward and the carry; K1c and
    # K2c's cluster kernels are those of every bf16 LSTM path (H512), their
    # grid builds those of bf16_wide_lstm's serving and training (H1024),
    # timed at H1024 (B16 forward, B32 with gates and backward). The forward
    # kernels' numbers are at the serving shape (B=16), the backward ones'
    # (and K1c's with the gate trace) at the training one (B=32), MLPG's at
    # the LSTM's B16 batch (library_ms: the dense torch.linalg.solve of the
    # same systems, for both rows). families_phase adds the multi-speaker and
    # VAE models' K3 (serving, training, the VAE's latent samples) and K4,
    # their bf16 serving's K3c, the MoE Transformer's attention forward
    # (serving, training) and backward and its bf16 serving's K5b, and every
    # family's MLPG but the multi-speaker model's. builder_phase adds the K1
    # (with gates) and K2 launches of its two uninterrupted resume runs, and
    # fast_path_phase those of its epoch of the defaults and its chained and
    # eager runs (LSTM and Duration; a captured step counts once, its
    # replays none).
    emit({'kernels': [{
        'name': 'lstm_fwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/lstm_fwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_rnn.py:77',
        'launches': serve_launches + generate_launches + test_launches + train_launches['k1']
        + pipeline_launches['k1'] + stream_launches['k1'] + http_launches['k1']
        + quantize_launches + export_launches['k1'] + builder['k1'] + fast['k1'],
        'max_abs_err': main_shape['max_abs_err_vs_plain'], 'ms': main_shape['kernel_ms'],
        'plain_ms': main_shape['plain_ms'], 'bound_ms': main_shape['bound_ms'],
        'bound_by': main_shape['bound_by'], 'library_ms': main_shape['library_ms']}, {
        'name': 'lstm_bwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/lstm_bwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_rnn.py:113',
        'launches': train_launches['k2'] + builder['k2'] + fast['k2'],
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
        'launches': f0_serve_launches + f0_train_launches['k3'] + duration_launches['k3']
        + pipeline_launches['k3'] + stream_launches['k3'] + http_launches['k3']
        + export_launches['k3'] + families['k3'] + fast['k3'],
        'max_abs_err': gru_fwd_shape['max_abs_err_vs_plain'], 'ms': gru_fwd_shape['kernel_ms'],
        'plain_ms': gru_fwd_shape['plain_ms'], 'bound_ms': gru_fwd_shape['bound_ms'],
        'bound_by': gru_fwd_shape['bound_by'], 'library_ms': gru_fwd_shape['library_ms']}, {
        'name': 'gru_bwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/gru_bwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_gru.py:59',
        'launches': f0_train_launches['k4'] + duration_launches['k4'] + families['k4']
        + fast['k4'],
        'max_abs_err': gru_bwd_shape['k4_max_abs_err'], 'ms': gru_bwd_shape['kernel_ms'],
        'plain_ms': gru_bwd_shape['plain_ms'], 'bound_ms': gru_bwd_shape['bound_ms'],
        'bound_by': gru_bwd_shape['bound_by'], 'library_ms': gru_bwd_shape['library_ms'],
        'layer_fwd_bwd_ms': gru_bwd_shape['layer_fwd_bwd_ms'],
        'hg_gemm_ms': gru_bwd_shape['hg_gemm_ms']}, {
        'name': 'attn_fwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/attn_fwd.cu',
        'replaces': 'morgana_tpu/nn.py:1001', 'also_replaces': 'morgana_tpu/nn.py:1055',
        'launches': attn_serve_launches + attn_train_launches['attn_fwd'] + stream_attn_launches
        + http_launches['attn'] + export_launches['attn_fwd'] + families['attn_fwd'],
        'max_abs_err': attn_fwd_shape['max_abs_err_vs_plain'], 'ms': attn_fwd_shape['kernel_ms'],
        'plain_ms': attn_fwd_shape['plain_ms'], 'bound_ms': attn_fwd_shape['bound_ms'],
        'bound_by': attn_fwd_shape['bound_by'], 'library_ms': attn_fwd_shape['library_ms'],
        'simt_bound_ms': attn_fwd_shape['simt_bound_ms']}, {
        'name': 'attn_bwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/attn_bwd.cu',
        'replaces': 'morgana_tpu/nn.py:1001', 'also_replaces': 'morgana_tpu/nn.py:1055',
        'launches': attn_train_launches['attn_bwd'] + families['attn_bwd'],
        'max_abs_err': attn_bwd_shape['bwd_max_abs_err'], 'ms': attn_bwd_shape['kernel_ms'],
        'plain_ms': attn_bwd_shape['plain_ms'], 'bound_ms': attn_bwd_shape['bound_ms'],
        'bound_by': attn_bwd_shape['bound_by'], 'library_ms': attn_bwd_shape['library_ms'],
        'simt_bound_ms': attn_bwd_shape['simt_bound_ms']}, {
        'name': 'mlpg', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/mlpg.cu',
        'replaces': 'morgana_tpu/ops/mlpg.py:201', 'also_replaces': 'morgana_tpu/ops/mlpg.py:88',
        'launches': fused_launches, 'max_abs_err': mlpg_shape['mlpg']['max_abs_err_vs_plain'],
        'ms': mlpg_shape['mlpg']['kernel_ms'], 'plain_ms': mlpg_shape['mlpg']['plain_ms'],
        'bound_ms': mlpg_shape['mlpg']['bound_ms'], 'bound_by': mlpg_shape['mlpg']['bound_by'],
        'library_ms': mlpg_shape['solve']['library_ms']}, {
        'name': 'mlpg_solve', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/mlpg.cu',
        'replaces': 'morgana_tpu/ops/mlpg.py:88', 'launches': mlpg_launches,
        'launches_of_the_solve_alone': mlpg_launches - fused_launches,
        'max_abs_err': mlpg_shape['solve']['max_abs_err_vs_plain'],
        'ms': mlpg_shape['solve']['kernel_ms'], 'plain_ms': mlpg_shape['solve']['plain_ms'],
        'bound_ms': mlpg_shape['solve']['bound_ms'], 'bound_by': mlpg_shape['solve']['bound_by'],
        'library_ms': mlpg_shape['solve']['library_ms']}] + [{
        'name': name, 'route': 'cuda', 'source': f'morgana_tpu_torch/csrc/{source}',
        'replaces': replaces, 'also_replaces': also, 'launches': bf16_launches[key] + train,
        'max_abs_err': bf16_shapes[key]['max_abs_err_vs_plain'],
        'ms': bf16_shapes[key]['kernel_ms'], 'plain_ms': bf16_shapes[key]['plain_ms'],
        'bound_ms': bf16_shapes[key]['bound_ms'], 'bound_by': bf16_shapes[key]['bound_by'],
        'library_ms': bf16_shapes[key]['library_ms'],
        # K5b's kernel outruns its wrapper's host time, so that CUDA events over
        # calls time the host: its ms, plain_ms and library_ms are the
        # profiler's device time, and the events' times are wrapper_ms,
        # plain_events_ms and library_events_ms.
        **({'ms': bf16_shapes[key]['device_ms'], 'ms_by': 'profiler (device time)',
            'plain_ms': bf16_shapes[key]['plain_device_ms'],
            'library_ms': bf16_shapes[key]['library_device_ms'],
            'wrapper_ms': bf16_shapes[key]['kernel_ms'],
            'plain_events_ms': bf16_shapes[key]['plain_ms'],
            'library_events_ms': bf16_shapes[key]['library_ms'],
            'tensor_map_encode_us': bf16_shapes[key]['tensor_map_encode_us']}
           if 'device_ms' in bf16_shapes[key] else {})}
        for name, key, train, source, replaces, also in (
            ('lstm_fwd_bf16_cluster', 'k1c',
             bf16_train['k1c_cluster'] - bf16_train['k1c_cluster_gates'], 'lstm_fwd_bf16.cu',
             'morgana_tpu/ops/pallas_rnn.py:77', 'morgana_tpu/ops/rnn.py:113'),
            ('gru_fwd_bf16_compute', 'k3c', bf16_train['k3c'] + families['k3c'],
             'gru_fwd_bf16.cu', 'morgana_tpu/ops/pallas_gru.py:35', 'morgana_tpu/ops/rnn.py:347'),
            ('attn_fwd_bf16', 'k5b', bf16_train['k5b'] + families['k5b'], 'attn_fwd_bf16.cu',
             'morgana_tpu/nn.py:1001', 'morgana_tpu/nn.py:1055'))] + [{
        'name': 'lstm_fwd_bf16_compute', 'route': 'cuda',
        'source': 'morgana_tpu_torch/csrc/lstm_fwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_rnn.py:77', 'also_replaces': 'morgana_tpu/ops/rnn.py:113',
        'launches': wide['k1c'], 'max_abs_err': bf16_shapes['k1c_grid']['max_abs_err_vs_plain'],
        'ms': bf16_shapes['k1c_grid']['kernel_ms'],
        'plain_ms': bf16_shapes['k1c_grid']['plain_ms'],
        'bound_ms': bf16_shapes['k1c_grid']['bound_ms'],
        'bound_by': bf16_shapes['k1c_grid']['bound_by'],
        'library_ms': bf16_shapes['k1c_grid']['library_ms']}] + [{
        'name': name, 'route': 'cuda', 'source': f'morgana_tpu_torch/csrc/{source}',
        'replaces': replaces, 'also_replaces': also,
        'launches': wide[launches[:-5]] if launches.endswith('_grid') else bf16_train[launches],
        'max_abs_err': bf16_bwd_shapes[key][err], 'ms': bf16_bwd_shapes[key]['kernel_ms'],
        'plain_ms': bf16_bwd_shapes[key]['plain_ms'],
        'bound_ms': bf16_bwd_shapes[key]['bound_ms'],
        'bound_by': bf16_bwd_shapes[key]['bound_by'],
        'library_ms': bf16_bwd_shapes[key]['library_ms']}
        for name, key, launches, err, source, replaces, also in (
            ('lstm_fwd_bf16_cluster_gates', 'k1c_gates', 'k1c_cluster_gates',
             'gate_trace_max_abs_err', 'lstm_fwd_bf16.cu', 'morgana_tpu/ops/pallas_rnn.py:77',
             'morgana_tpu/ops/rnn.py:113'),
            ('lstm_bwd_bf16_cluster', 'k2c', 'k2c_cluster', 'max_abs_err_vs_plain',
             'lstm_bwd_bf16.cu', 'morgana_tpu/ops/pallas_rnn.py:113', 'morgana_tpu/ops/rnn.py:113'),
            ('lstm_fwd_bf16_compute_gates', 'k1c_gates_grid', 'k1c_gates_grid',
             'gate_trace_max_abs_err', 'lstm_fwd.cu', 'morgana_tpu/ops/pallas_rnn.py:77',
             'morgana_tpu/ops/rnn.py:113'),
            ('lstm_bwd_bf16_compute', 'k2c_grid', 'k2c_grid', 'max_abs_err_vs_plain', 'lstm_bwd.cu',
             'morgana_tpu/ops/pallas_rnn.py:113', 'morgana_tpu/ops/rnn.py:113'),
            ('gru_bwd_bf16_compute', 'k4c', 'k4c', 'max_abs_err_vs_plain', 'gru_bwd_bf16.cu',
             'morgana_tpu/ops/pallas_gru.py:59', 'morgana_tpu/ops/rnn.py:347'),
            ('attn_bwd_bf16', 'k5b_bwd', 'k5b_bwd', 'max_abs_err_vs_plain', 'attn_bwd_bf16.cu',
             'morgana_tpu/nn.py:1001', 'morgana_tpu/nn.py:1055'),
            ('rnn_dw_bf16', 'carry', 'carry', 'max_abs_err_vs_plain', 'rnn_dw_bf16.cu',
             'morgana_tpu/ops/rnn.py:120', 'morgana_tpu/ops/rnn.py:351'))]})
    print(nvidia_smi(), flush=True)
    if mlpg_failures:
        raise AssertionError(f'mlpg_kernel failed: {mlpg_failures}')
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
