#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc)::

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the script with a non-zero exit
code and without the final line:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is turned off for matmuls and cuDNN.
2. build: every kernel under morgana_tpu_torch/csrc, built from source.
3. kernel K1 (the LSTM layer recurrence) against its plain PyTorch version
   and against torch.nn.LSTM (cuDNN, a yardstick the port never calls), at
   H=512, ragged seq_len, with and without an initial state; times.
4. k2: the gradient path of the LSTM layer, K1 writing its gate trace and
   K2 (the backward), against autograd through the plain recurrence, for a
   loss on y, hn and cn under ragged seq_len; the gate trace against the
   plain gates; times of K2, of K1 with and without the gate trace, and of
   one torch.nn.LSTM forward+backward (cuDNN) beside the port's layer.
5. serving: LSTMAcousticModel at full width (609 inputs, 8 x LSTM(512),
   199 outputs) with seeded weights and normaliser statistics, served by
   InferenceEngine.predict_items on 32 utterances of 200-1000 frames; checks
   shapes, finiteness, K1's launch count and agreement with the same engine
   on the CPU; throughput, peak memory and where a batch's time goes.
6. train: the same model trained at full width by the port's
   ExperimentBuilder with the JAX package's defaults (B=32, Adam, lr 0.01,
   constant schedule) for 2 epochs with validation, on a synthetic corpus of
   64 + 16 utterances of about 200-1000 frames, from a seeded epoch_0.npz;
   checks finite losses and metrics, 8 launches each of K1-with-gates and
   K2 per train step, K1 without gates in validation, the outputs and the
   checkpoint's strict reload; ms per step, frames/s, peak memory and where
   a step's time goes.
7. train_parity: the same trainer on the GPU and on the CPU (plain
   versions) from the same init and data, 3 steps of B=4 at full width:
   per-step losses and the first step's gradients.

Then a line {"kernels": [...]} with each kernel's numbers at its main
path's shape, the nvidia-smi line, and last {"ok": true, "device": {...}}.
Needs no network and writes only to a temporary directory. The profiler's
device-time tables go to stderr.
"""
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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
KERNEL_TOL = 1e-4           # K1 vs plain and vs cuDNN, f32, abs; also the gate trace
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


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def k1_bound(batch, time_steps, hidden, gates=False):
    """Least time for the recurrence: 2*B*H*4H flops per step against the
    float32 peak, and xg read plus y and c_all written (with w_hh, h0, c0
    read and hn, cn written; with `gates`, g_all (T, B, 4H) written too)
    against the memory rate."""
    flops = 2.0 * batch * hidden * 4 * hidden * time_steps
    nbytes = 4.0 * ((2 if gates else 1) * time_steps * batch * 4 * hidden
                    + 2 * time_steps * batch * hidden + hidden * 4 * hidden + 4 * batch * hidden)
    ops_ms, bytes_ms = flops / F32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms else 'bytes')


def k2_bound(batch, time_steps, hidden):
    """Least time for the backward recurrence: 2*B*4H*H flops per step
    (dh = dxg @ w_hh^T) against the float32 peak, and g_all read plus dxg
    written, c_all, dy and dc_all read (with w_hh, c0, dhn, dcn read and
    dh0, dc0 written) against the memory rate."""
    flops = 2.0 * batch * 4 * hidden * hidden * time_steps
    nbytes = 4.0 * (2 * time_steps * batch * 4 * hidden + 3 * time_steps * batch * hidden
                    + hidden * 4 * hidden + 5 * batch * hidden)
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


def k1_case(torch, dev, batch, time_steps, with_state, seed, timed):
    from morgana_tpu_torch.ops import lstm as lstm_ops

    x, (w_ih, w_hh, b_ih, b_hh), seq_len, h0, c0 = layer_inputs(
        torch, dev, batch, time_steps, with_state, seed)
    cudnn = cudnn_layer(torch, dev, w_ih, w_hh, b_ih, b_hh)

    with torch.inference_mode():
        y_k, (hn_k, cn_k) = lstm_ops.lstm_layer(x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0)
        y_p, (hn_p, cn_p) = lstm_ops.lstm_layer_reference(x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0)
        torch.cuda.synchronize()
        err_plain = max(float((a - b).abs().max()) for a, b in
                        ((y_k, y_p), (hn_k, hn_p), (cn_k, cn_p)))

        hx = None if h0 is None else (h0[None].contiguous(), c0[None].contiguous())
        y_c, _ = cudnn(x, hx)
        mask = (torch.arange(time_steps, device=dev)[None, :] < seq_len[:, None])[:, :, None]
        hn_c = torch.gather(y_c, 1, (seq_len - 1)[:, None, None].expand(batch, 1, H))[:, 0]
        err_cudnn = max(float((y_k - y_c * mask).abs().max()), float((hn_k - hn_c).abs().max()))

        out = {'phase': 'k1', 'B': batch, 'T': time_steps, 'H': H, 'initial_state': with_state,
               'seq_len_min': int(seq_len.min()), 'seq_len_max': int(seq_len.max()),
               'max_abs_err_vs_plain': err_plain, 'max_abs_err_vs_cudnn': err_cudnn,
               'tolerance': KERNEL_TOL}
        if timed:
            xg = (torch.matmul(x, w_ih) + (b_ih + b_hh)).transpose(0, 1).contiguous()
            zeros = torch.zeros((batch, H), device=dev)
            hs, cs = (zeros, zeros) if h0 is None else (h0, c0)
            out['kernel_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_recurrence(xg, w_hh, hs, cs), 20)
            out['plain_ms'] = cuda_ms(
                torch, lambda: lstm_ops.lstm_recurrence_reference(xg, w_hh, hs, cs), 2)
            out['layer_ms'] = cuda_ms(
                torch, lambda: lstm_ops.lstm_layer(x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0), 20)
            out['library_ms'] = cuda_ms(torch, lambda: cudnn(x, hx), 20)
            out['bound_ms'], out['bound_by'] = k1_bound(batch, time_steps, H)
        out['launches'] = lstm_ops.launches
    emit(out)
    if not (err_plain <= KERNEL_TOL and err_cudnn <= KERNEL_TOL):
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


def k2_case(torch, dev, batch, time_steps, with_state, seed, timed):
    """The gradient path (K1 with gates, then K2) against autograd through
    the plain recurrence; the gate trace against the plain gates; with
    `timed`, the times of K2, of K1 with and without gates, and of a layer
    forward+backward beside cuDNN's."""
    from morgana_tpu_torch.ops import lstm as lstm_ops

    x, weights, seq_len, h0, c0 = layer_inputs(torch, dev, batch, time_steps, with_state, seed)
    rng = np.random.default_rng(seed + 100)
    loss_weights = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                    for shape in ((batch, time_steps, H), (batch, H), (batch, H))]
    names = ('dx', 'dw_ih', 'dw_hh', 'db_ih', 'db_hh', 'dh0', 'dc0')

    before = (lstm_ops.gate_launches, lstm_ops.bwd_launches)
    got = layer_grads(torch, lstm_ops.lstm_layer, x, weights, seq_len, h0, c0, loss_weights)
    torch.cuda.synchronize()
    launched = (lstm_ops.gate_launches - before[0], lstm_ops.bwd_launches - before[1])
    want = layer_grads(torch, lstm_ops.lstm_layer_reference, x, weights, seq_len, h0, c0,
                       loss_weights)
    grad_rel = {n: float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for n, g, w in zip(names, got, want)}

    w_ih, w_hh, b_ih, b_hh = weights
    zeros = torch.zeros((batch, H), device=dev)
    hs, cs = (zeros, zeros) if h0 is None else (h0, c0)
    xg = (torch.matmul(x, w_ih) + (b_ih + b_hh)).transpose(0, 1).contiguous()
    _, c_all, g_kernel, _, _ = lstm_ops.lstm_recurrence(xg, w_hh, hs, cs, with_gates=True)
    _, _, g_plain, _, _ = lstm_ops.lstm_recurrence_reference(xg, w_hh, hs, cs)
    gate_err = float((g_kernel - g_plain).abs().max())

    # K2 alone against its plain version on the same saved tensors.
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
           for shape in ((time_steps, batch, H), (time_steps, batch, H), (batch, H), (batch, H))]
    bwd_args = (g_kernel, w_hh, cs, c_all, *cot)
    dxg_k = lstm_ops.lstm_backward(*bwd_args)
    dxg_p = lstm_ops.lstm_backward_reference(*bwd_args)
    k2_err = max(float((a - b).abs().max()) for a, b in zip(dxg_k, dxg_p))
    k2_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                 for a, b in zip(dxg_k, dxg_p))

    out = {'phase': 'k2', 'B': batch, 'T': time_steps, 'H': H, 'initial_state': with_state,
           'grad_rel_err_vs_plain': grad_rel, 'grad_rtol': GRAD_RTOL,
           'gate_trace_max_abs_err': gate_err, 'gate_tol': KERNEL_TOL,
           'k2_max_abs_err': k2_err, 'k2_rel_err': k2_rel,
           'k1_gate_launches': launched[0], 'k2_launches': launched[1]}
    if timed:
        out['kernel_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_backward(*bwd_args), 10)
        out['plain_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_backward_reference(*bwd_args), 2)
        out['bound_ms'], out['bound_by'] = k2_bound(batch, time_steps, H)
        out['k1_ms'] = cuda_ms(torch, lambda: lstm_ops.lstm_recurrence(xg, w_hh, hs, cs), 10)
        out['k1_gates_ms'] = cuda_ms(
            torch, lambda: lstm_ops.lstm_recurrence(xg, w_hh, hs, cs, with_gates=True), 10)
        out['k1_gates_bound_ms'], out['k1_gates_bound_by'] = k1_bound(batch, time_steps, H, True)
        out['layer_fwd_bwd_ms'] = cuda_ms(torch, lambda: layer_grads(
            torch, lstm_ops.lstm_layer, x, weights, seq_len, h0, c0, loss_weights), 5)
        cudnn = cudnn_layer(torch, dev, *weights)
        hx = None if h0 is None else (h0[None].contiguous(), c0[None].contiguous())

        def cudnn_fwd_bwd():
            y_c, _ = cudnn(x, hx)
            (y_c * loss_weights[0]).sum().backward()

        # cuDNN's backward cannot be timed alone: this includes its forward.
        out['library_ms'] = cuda_ms(torch, cudnn_fwd_bwd, 5)
    emit(out)
    if not (max(grad_rel.values()) <= GRAD_RTOL and gate_err <= KERNEL_TOL
            and k2_rel <= GRAD_RTOL and launched == (1, 1)):
        raise AssertionError(f'K1 with gates / K2 disagree at B={batch} T={time_steps}: {out}')
    return out


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


def serving_phase(torch, root):
    from morgana_tpu_torch import data
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.serve import InferenceEngine
    from morgana_tpu_torch.viz.synthesis import MLPG_streams

    seed = 0
    rng = np.random.default_rng(seed)
    model = LSTMAcousticModel(generator=torch.Generator().manual_seed(seed))
    ckpt = os.path.join(root, 'epoch_1.npz')
    np.savez(ckpt, **{k: v.detach().numpy() for k, v in model.named_parameters()})
    write_normalisers(root, rng)
    items = make_items(rng)

    engine = InferenceEngine(LSTMAcousticModel, ckpt, data_root=root, batch_size=SERVE_BATCH)
    engine.predict_items(items[:2])   # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    lstm_ops.launches = 0
    start = time.perf_counter()
    outputs = engine.predict_items(items)      # returns host arrays: ends synchronised
    seconds = time.perf_counter() - start
    launches = lstm_ops.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    n_batches = -(-N_UTTS // SERVE_BATCH)

    dims = {'normalised_lf0_deltas': 3, 'normalised_mcep_deltas': 180,
            'normalised_bap_deltas': 15, 'lf0': 1, 'vuv': 1, 'mcep': 60, 'bap': 5}
    frames = 0
    for item in items:
        n = int(item['n_frames'].reshape(-1)[0])
        frames += n
        out = outputs[item['name']]
        for key, dim in dims.items():
            if out[key].shape != (n, dim) or not np.isfinite(out[key]).all():
                raise AssertionError(f"{item['name']} {key}: shape {out[key].shape}, "
                                     f'expected ({n}, {dim}), finite={np.isfinite(out[key]).all()}')
    if launches != 8 * n_batches:
        raise AssertionError(f'K1 launched {launches} times for {n_batches} batches, '
                             f'expected {8 * n_batches}')

    # The same checkpoint on the CPU (plain versions) for the shortest utterances.
    few = sorted(items, key=lambda it: int(it['n_frames'].reshape(-1)[0]))[:4]
    cpu = InferenceEngine(LSTMAcousticModel, ckpt, data_root=root, device='cpu',
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
            raise AssertionError(f'{key}: GPU vs CPU {worst} beyond tolerance')

    # Where one full-size batch's time goes: host clock around synchronised
    # calls, and the profiler's device time by kernel.
    features = data.collate([data.assemble_item(
        engine.model.test_data_sources(), engine.model.normalisers,
        lambda name, source, item=item: source.package(item[name]), item['name'])
        for item in items[:SERVE_BATCH]])
    batch = {k: torch.from_numpy(v).cuda() for k, v in features.items()
             if isinstance(v, np.ndarray) and v.dtype.kind in 'fiub'}
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
    emit({'phase': 'serve', 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
          'utterances': N_UTTS, 'frames': frames, 'batch_size': SERVE_BATCH,
          'batches': n_batches, 'seconds': seconds,
          'utterances_per_s': N_UTTS / seconds, 'frames_per_s': frames / seconds,
          'ms_per_batch': seconds / n_batches * 1e3,
          'peak_memory_mib': peak_mib,
          'k1_launches': launches, 'k1_launches_expected': 8 * n_batches,
          'gpu_vs_cpu_err': errs, 'net_tol': NET_TOL, 'traj_rtol': TRAJ_RTOL})
    emit(dict({'phase': 'batch_breakdown', 'B': SERVE_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'predict_ms': predict_ms, 'inputs_ms': inputs_ms, 'network_ms': net_ms,
               'mlpg_ms': mlpg_ms}, **profile))
    return launches


def seeded_checkpoint(torch, path, seed):
    """A full-width LSTMAcousticModel with weights from `seed`, saved as the
    JAX package's epoch_0.npz."""
    from morgana_tpu_torch import checkpointing, nn
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel

    model = LSTMAcousticModel(generator=torch.Generator().manual_seed(seed))
    return checkpointing.save_state_dict(nn.state_dict(model), path)


def builder_argv(data_root, experiments_base, name, ckpt, *flags):
    """The training command line of the main path: the JAX package's
    defaults, with the corpus, the init and the output named."""
    return ['--experiment_name', name, '--experiments_base', experiments_base,
            '--data_root', data_root, '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp', '--checkpoint_path', ckpt,
            *flags]


def train_phase(torch, root):
    """Trains the full-width model for 2 epochs through the ExperimentBuilder
    on the card and checks what it wrote; then times and profiles steps."""
    from morgana_tpu_torch import nn
    from morgana_tpu_torch.data.synthetic import generate_voice_data
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.ops import lstm as lstm_ops
    from morgana_tpu_torch.data import device_features
    from morgana_tpu_torch.viz.synthesis import MLPG_streams

    data_root = os.path.join(root, 'train_data')
    start = time.perf_counter()
    generate_voice_data(data_root, num_train=64, num_valid=16, num_test=0, seed=7,
                        n_phones_range=(40, 120), dur_range=(5, 10))
    corpus_s = time.perf_counter() - start
    ckpt = seeded_checkpoint(torch, os.path.join(root, 'init', 'epoch_0.npz'), 11)
    exp_base = os.path.join(root, 'experiments')
    args = ExperimentBuilder.get_experiment_args(
        builder_argv(data_root, exp_base, 'train', ckpt, '--end_epoch', '2'))
    exp = ExperimentBuilder(LSTMAcousticModel, **args)
    steps_per_epoch = len(exp.train_loader)
    valid_batches = len(exp.valid_loader)
    layers = sum(isinstance(m, nn.Recurrent) for m in exp.model.modules())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lstm_ops.launches = lstm_ops.gate_launches = lstm_ops.bwd_launches = 0
    start = time.perf_counter()
    exp.run_experiment()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    launches = {'k1': lstm_ops.launches, 'k1_gates': lstm_ops.gate_launches,
                'k2': lstm_ops.bwd_launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    train_steps = 2 * steps_per_epoch
    expected = {'k1': layers * (train_steps + 2 * valid_batches),
                'k1_gates': layers * train_steps, 'k2': layers * train_steps}
    if launches != expected:
        raise AssertionError(f'launches {launches}, expected {expected}')
    exp_dir = os.path.join(exp_base, 'train')
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

    # Steady-state steps on one full batch, host clock around synchronised
    # calls; then one profiled step and the MLPG's share of it.
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
    model = exp.model
    batch = device_features(features, exp.device)
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
        mlpg_ms = (time.perf_counter() - t0) * 1e3

    emit({'phase': 'train', 'model': 'LSTMAcousticModel 609-8xLSTM(512)-199',
          'corpus': '64 train + 16 valid, n_phones 40-119, dur 5-9', 'corpus_seconds': corpus_s,
          'batch_size': TRAIN_BATCH, 'epochs': 2, 'steps_per_epoch': steps_per_epoch,
          'run_seconds': run_s, 'step_losses': step_losses,
          'train_metrics': {k: v for k, v in epoch_metrics.items() if k.startswith('train')},
          'valid_metrics': {k: v for k, v in epoch_metrics.items() if k.startswith('valid')},
          'lstm_layers': layers, 'launches': launches, 'launches_expected': expected,
          'k1_gate_launches_per_step': launches['k1_gates'] / train_steps,
          'k2_launches_per_step': launches['k2'] / train_steps,
          'peak_memory_mib': peak_mib})
    emit(dict({'phase': 'train_step_breakdown', 'B': TRAIN_BATCH,
               'T': int(features['normalised_counters'].shape[1]),
               'frames': float(np.sum(features['n_frames'])),
               'step_ms': step_ms, 'median_step_ms_after_first': float(np.median(step_ms[1:])),
               'mlpg_host_ms': mlpg_ms}, **profile))
    return launches


def train_parity_phase(torch, root):
    """The same trainer on the GPU and on the CPU, from one init and one
    corpus: per-step losses and the first step's gradients."""
    from morgana_tpu_torch.data.synthetic import generate_voice_data
    from morgana_tpu_torch.experiment_builder import ExperimentBuilder
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel

    data_root = os.path.join(root, 'parity_data')
    generate_voice_data(data_root, num_train=4, num_valid=0, num_test=0, seed=8,
                        n_phones_range=(20, 40), dur_range=(5, 8))
    ckpt = seeded_checkpoint(torch, os.path.join(root, 'parity_init', 'epoch_0.npz'), 12)
    runs = {}
    for device in ('cuda', 'cpu'):
        args = ExperimentBuilder.get_experiment_args(builder_argv(
            data_root, os.path.join(root, 'parity_experiments'), device, ckpt,
            '--device', device, '--batch_size', '4', '--no-valid', '--end_epoch', '3'))
        exp = ExperimentBuilder(LSTMAcousticModel, **args)
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
    emit({'phase': 'train_parity', 'B': 4, 'padded_T': frames, 'gpu_losses': gpu_losses,
          'cpu_losses': cpu_losses, 'loss_rel_err': loss_rel, 'loss_rtol': TRAIN_LOSS_RTOL,
          'max_grad_rel_err': grad_rel[worst], 'worst_param': worst,
          'grad_rtol': TRAIN_GRAD_RTOL})
    if max(loss_rel) > TRAIN_LOSS_RTOL or grad_rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError('GPU trainer disagrees with the CPU trainer')


def kernel_kind(name):
    """The part of a step a device kernel belongs to, by its name."""
    if 'lstm_fwd_kernel' in name:
        return 'k1'
    if 'lstm_bwd_kernel' in name:
        return 'k2'
    lower = name.lower()
    if 'gemm' in lower:
        return 'gemm'
    if 'multi_tensor_apply' in lower or 'adam' in lower:
        return 'adam'
    return 'other'


def profile_step(torch, fn):
    """One profiled call: device time by kernel (K1, K2, GEMMs, Adam's
    multi-tensor kernels, the rest), the number of kernels, and the host ops
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
    device_us = {'k1': 0.0, 'k2': 0.0, 'gemm': 0.0, 'adam': 0.0, 'other': 0.0}
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


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 2
    from morgana_tpu_torch import _build

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({'phase': 'device', 'nvidia_smi': smi, 'name': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'python': sys.version.split()[0],
          'tf32_matmul': False, 'tf32_cudnn': False})

    start = time.perf_counter()
    paths = _build.build()
    logs = {}
    for name, path in paths.items():
        with open(os.path.splitext(path)[0] + '.log') as f:
            logs[name] = [line.strip() for line in f if 'Used' in line or 'spill' in line]
    emit({'phase': 'build', 'seconds': time.perf_counter() - start,
          'kernels': {k: os.path.relpath(v) for k, v in paths.items()}, 'ptxas': logs})

    # K1 against its plain version and cuDNN: B=32 (the training batch), the
    # serving path's shape, and edge shapes (T=1, B not a multiple of 32,
    # two 32-row slices).
    dev = torch.device('cuda')
    k1_case(torch, dev, 32, 1024, True, 1, timed=True)
    k1_case(torch, dev, 32, 1024, False, 2, timed=True)
    main_shape = k1_case(torch, dev, SERVE_BATCH, 1024, False, 3, timed=True)
    for batch, steps in ((5, 1), (1, 17), (40, 33)):
        k1_case(torch, dev, batch, steps, True, 4, timed=False)

    # K1 with gates and K2 at the training shape, with and without an
    # initial state, and at the edge shapes.
    train_shape = k2_case(torch, dev, TRAIN_BATCH, 1024, False, 5, timed=True)
    k2_case(torch, dev, TRAIN_BATCH, 1024, True, 6, timed=True)
    for batch, steps in ((5, 1), (1, 17), (40, 33)):
        k2_case(torch, dev, batch, steps, True, 7, timed=False)

    with tempfile.TemporaryDirectory() as root:
        serve_launches = serving_phase(torch, root)
        train_launches = train_phase(torch, root)
        train_parity_phase(torch, root)
    if not (serve_launches and train_launches['k1_gates'] and train_launches['k2']):
        raise AssertionError('a kernel of the main path was not launched')

    # launches: the main paths' runs (serving, then training), each counted
    # from 0. K1's numbers are at the serving shape, K2's at the training one.
    emit({'kernels': [{
        'name': 'lstm_fwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/lstm_fwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_rnn.py:77',
        'launches': serve_launches + train_launches['k1'],
        'max_abs_err': main_shape['max_abs_err_vs_plain'], 'ms': main_shape['kernel_ms'],
        'plain_ms': main_shape['plain_ms'], 'bound_ms': main_shape['bound_ms'],
        'bound_by': main_shape['bound_by'], 'library_ms': main_shape['library_ms']}, {
        'name': 'lstm_bwd', 'route': 'cuda', 'source': 'morgana_tpu_torch/csrc/lstm_bwd.cu',
        'replaces': 'morgana_tpu/ops/pallas_rnn.py:113', 'launches': train_launches['k2'],
        'max_abs_err': train_shape['k2_max_abs_err'], 'ms': train_shape['kernel_ms'],
        'plain_ms': train_shape['plain_ms'], 'bound_ms': train_shape['bound_ms'],
        'bound_by': train_shape['bound_by'], 'library_ms': train_shape['library_ms']}]})
    print(nvidia_smi(), flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
