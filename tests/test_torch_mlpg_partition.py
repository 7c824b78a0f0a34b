"""MLPG's banded solve (``csrc/mlpg.cu``) modelled on the CPU, and the op
``morgana::mlpg`` that fuses the system build into it.

The kernel cannot run here, so :func:`partition_solve` does its arithmetic
in its order, one rounded operation for each of the kernel's, vectorised
over the (segment, lane) pairs that the kernel gives a thread each:

1. the factor ``P = L L^T`` of each lane's valid rows ``[0, n)``: the
   plain loop's, in float32, one thread a lane (:func:`loop_factor`; its
   root correctly rounded, as on the card: the CPU's ``torch.sqrt`` is not
   always);
2. the rows cut into segments of ``m = max(ceil(n / S), BW, 1)`` rows; in
   float64 each segment forward-substitutes ``L y = b`` for BW + 1
   right-hand sides (b with the y entering it taken as 0, and the unit
   responses to the BW values ``z`` entering it);
3. ``z`` carried from segment to segment (one thread a lane);
4. each segment back-substitutes ``L^T x = y`` likewise, for the BW values
   ``w`` of x entering it from the right;
5. ``w`` carried from the last segment back;
6. ``x = xp + G w``, rounded to float32 once.

The factor is the loop's because on MLPG's padded systems the float32
loop's own error (most of it its factor's) is of the order of
``MLPG_RTOL``, the bar the kernel is held to against the loop: a solve
with another factor misses the loop by about as much. The substitutions
are linear recurrences, exact however they are split. Each case is held to
the plain loop within ``MLPG_RTOL`` of the largest |x|, and to a float64
solve of the same f32 system: its max and mean error at most twice the
plain loop's own plus one f32 ulp of the largest |x|. The op's CPU
implementation is the plain path (build, loop, unpad) bit for bit and holds
to the JAX package's ``mlpg`` as ``tests/test_torch_ops.py`` does.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from morgana_tpu.ops.mlpg import mlpg as jmlpg
from morgana_tpu.viz.synthesis import mlpg_numpy

from morgana_tpu_torch.ops import mlpg as tmlpg

MLPG_RTOL = 1e-6
JAX_RTOL = 5e-6     # tests/test_torch_ops.py's bars for mlpg
F64_RTOL = 2e-5
MIN_PIVOT = 1e-20
F64 = torch.float64

WINDOWS = {
    0: ((0, 0, (1.0,)),),
    2: tmlpg.DEFAULT_WINDOWS,
    4: ((0, 0, (1.0,)), (1, 1, (-0.5, 0.0, 0.5)), (2, 2, (0.1, -0.2, 0.2, -0.2, 0.1))),
}


def _where(mask, new, old):
    return torch.where(mask, new, old)


def _gather(rows, index):
    """``rows[index[s, l], l]`` for a (T', L) tensor and an (S, L) index
    (clamped into range; the caller masks what falls outside)."""
    tp = rows.shape[0]
    idx = index.clamp(0, max(tp - 1, 0))
    return rows.gather(0, idx) if tp else torch.zeros(index.shape, dtype=rows.dtype)


def loop_factor(bands):
    """The plain loop's factor (``ops/mlpg.py:_banded_cholesky_solve``), its
    operations in its order in float32, its root correctly rounded: (T', BW
    + 1, L), row i holding ``L[i, i - BW .. i]``."""
    bw = bands.shape[0] - 1
    tp, lanes = bands.shape[1:]
    zero, one = torch.zeros(lanes), torch.ones(lanes)
    row_p = [bands[0]] + [torch.cat([torch.zeros((p, lanes)), bands[p][:tp - p]])[:tp]
                          for p in range(1, bw + 1)]
    prev = [[zero] * bw + [one] for _ in range(bw)]
    rows = []
    for i in range(tp):
        r = [None] * (bw + 1)
        for p in range(bw, 0, -1):
            s = row_p[p][i]
            for qp in range(bw - p):
                s = s - r[qp] * prev[p - 1][qp + p]
            r[bw - p] = s / prev[p - 1][bw]
        s = row_p[0][i]
        for q in range(bw):
            s = s - r[q] * r[q]
        r[bw] = torch.sqrt(torch.clamp(s, min=MIN_PIVOT).double()).float()
        prev = [r] + prev[:-1]
        rows.append(torch.stack(r))
    return torch.stack(rows) if tp else torch.zeros((0, bw + 1, lanes))


def _carry(ends, segments, order):
    """The BW values entering each segment from its neighbour, carried in
    ``order``: ``ends[k][t]`` (S, L) are a segment's BW boundary rows (the
    values with 0 entering, and the unit responses); the first segment in
    ``order`` gets 0."""
    bw = len(ends)
    lanes = ends[0][0].shape[1] if bw else 0
    into = [torch.zeros(lanes, dtype=F64)] * bw
    got = [None] * segments
    for s in order:
        got[s] = into
        nxt = []
        for k in range(bw):
            acc = ends[k][0][s]
            for k2 in range(bw):
                acc = acc + ends[k][1 + k2][s] * into[k2]
            nxt.append(acc)
        into = nxt
    return [torch.stack([got[s][k] for s in range(segments)]) for k in range(bw)]


def _push(win, values, inside):
    """The window of the last BW rows' values, ``values`` pushed in where
    ``inside``."""
    return [[_where(inside, new[t], old[t]) for t in range(len(old))]
            for new, old in zip([values] + win[:-1], win)]


def partition_solve(b, bands, valid, segments):
    """``P x = b`` in every lane of (T', L), ``bands[m][i] = P[i, i + m]``,
    over each lane's first ``valid`` rows (x = 0 past them): the loop's
    factor, then the substitutions over ``segments`` segments a lane in
    float64, as the kernel does them."""
    bw = bands.shape[0] - 1
    tp, lanes = b.shape
    k1 = max(bw, 1)
    nrhs = bw + 1
    factor = loop_factor(bands).double()
    b64 = b.double()
    zero = torch.zeros((segments, lanes), dtype=F64)
    one = torch.ones((segments, lanes), dtype=F64)

    n = valid.reshape(1, lanes).long()
    m = torch.clamp((n + segments - 1) // segments, min=k1)
    s_eff = (n + m - 1) // m
    s_idx = torch.arange(segments)[:, None]
    a = s_idx * m
    active = s_idx < s_eff
    e = torch.minimum(a + m, n)
    m_max = int(m.max()) if lanes else 0

    def row(i):
        """L's row i of each (segment, lane), 0 outside the lane's rows."""
        ok = (i >= 0) & (i < n)
        return [_where(ok, _gather(factor[:, q], i), zero) for q in range(bw + 1)]

    def unit():
        """The values before a segment's first row (after its last): the
        k-th unit right-hand side for the k-th row beyond it."""
        return [[one if t == k + 1 else zero for t in range(nrhs)] for k in range(bw)]

    # Forward: y = yp + H z over each segment.
    win = unit()
    stored = []
    for j in range(m_max):
        i = a + j
        inside = active & (i < e)
        li = row(i)
        rinv = 1.0 / _where(inside, li[bw], one)
        bi = _where(inside, _gather(b64, i), zero)
        v = []
        for t in range(nrhs):
            s = bi if t == 0 else zero
            for p in range(1, bw + 1):
                s = s - li[bw - p] * win[p - 1][t]
            v.append(s * rinv)
        stored.append(v)
        win = _push(win, v, inside)
    z = _carry(win, segments, range(segments))

    # Backward: x = xp + G w over each segment, y = yp + H z row by row.
    win = unit()
    for j in range(m_max - 1, -1, -1):
        i = a + j
        inside = active & (i < e)
        v = stored[j]
        y = v[0]
        for k in range(bw):
            y = y + v[1 + k] * z[k]
        rinv = 1.0 / _where(inside, row(i)[bw], one)
        below = [row(i + p)[bw - p] for p in range(1, bw + 1)]
        u = []
        for t in range(nrhs):
            s = y if t == 0 else zero
            for p in range(1, bw + 1):
                s = s - below[p - 1] * win[p - 1][t]
            u.append(s * rinv)
        stored[j] = u
        win = _push(win, u, inside)
    w = _carry(win, segments, range(segments - 1, -1, -1))

    x = torch.zeros((tp, lanes), dtype=F64)
    cols = torch.arange(lanes).expand(segments, lanes)
    for j in range(m_max):
        i = a + j
        inside = active & (i < e)
        u = stored[j]
        xi = u[0]
        for k in range(bw):
            xi = xi + u[1 + k] * w[k]
        x[i[inside], cols[inside]] = xi[inside]
    return x.float()


def factor_solve_f64(b, bands, valid):
    """The loop's factor, then both substitutions as float64 triangular
    solves (scipy), lane by lane over its valid rows: what the partition's
    substitutions compute, unsplit."""
    bw = bands.shape[0] - 1
    factor = loop_factor(bands).double().numpy()
    x = np.zeros(b.shape)
    for lane, n in enumerate(valid.tolist()):
        if n == 0:
            continue
        low = np.zeros((bw + 1, n))   # solve_banded's (l=BW, u=0) layout
        up = np.zeros((bw + 1, n))
        for p in range(min(bw + 1, n)):
            low[p, :n - p] = factor[p:n, bw - p, lane]
            up[bw - p, p:] = factor[p:n, bw - p, lane]
        y = scipy.linalg.solve_banded((bw, 0), low, b[:n, lane].double().numpy())
        x[:n, lane] = scipy.linalg.solve_banded((0, bw), up, y)
    return x


def banded_f64(b, bands, valid):
    """Float64 solutions of the same f32 systems (scipy's banded Cholesky),
    lane by lane over each lane's valid rows."""
    bw = bands.shape[0] - 1
    b64, bands64 = b.double().numpy(), bands.double().numpy()
    x = np.zeros(b64.shape)
    for lane, n in enumerate(valid.tolist()):
        if n == 0:
            continue
        upper = np.zeros((bw + 1, n))
        for mm in range(min(bw + 1, n)):
            upper[bw - mm, mm:] = bands64[mm, :n - mm, lane]
        x[:n, lane] = scipy.linalg.solveh_banded(upper, b64[:n, lane])
    return x


def assert_near_float64(got, plain, exact):
    """Max and mean |error| against float64 no more than twice the plain
    loop's own, plus one f32 ulp of the largest |x|."""
    ulp = float(np.spacing(np.float32(np.abs(exact).max()))) if exact.size else 0.0
    err = np.abs(np.asarray(got, np.float64) - exact)
    own = np.abs(np.asarray(plain, np.float64) - exact)
    assert err.max() <= 2 * own.max() + ulp, (err.max(), own.max(), ulp)
    assert err.mean() <= 2 * own.mean() + ulp, (err.mean(), own.mean(), ulp)


def assert_near_plain(got, plain):
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((got - plain).abs().max()) if plain.numel() else 0.0
    assert err <= MLPG_RTOL * scale, (err, scale)


@functools.lru_cache(maxsize=None)
def _case(bandwidth, frames):
    """An MLPG system of 4 items x 2 features (8 lanes) over T' = ``frames``
    with padding 0, ragged valid lengths (full, 0, one row, ~half), its
    plain solution and its float64 one."""
    rng = np.random.default_rng(frames * 10 + bandwidth)
    windows = WINDOWS[bandwidth]
    means = rng.normal(size=(4, frames, len(windows) * 2)).astype(np.float32)
    variances = rng.uniform(0.2, 2.0, size=(4, frames, len(windows) * 2)).astype(np.float32)
    seq_len = torch.tensor([frames, 0, 1, max(frames // 2, 1)])
    b, bands, _ = tmlpg.banded_system(torch.from_numpy(means), torch.from_numpy(variances),
                                      windows, 0, seq_len)
    valid = torch.repeat_interleave(seq_len, 2)
    plain = tmlpg._banded_cholesky_solve(b, list(bands.unbind(0)), bandwidth)
    return b, bands, valid, plain, banded_f64(b, bands, valid)


@pytest.mark.parametrize('frames', [3, 17, 1224])
@pytest.mark.parametrize('segments', [1, 4, 32])
@pytest.mark.parametrize('bandwidth', [0, 2, 4])
def test_partition_solve_holds_to_the_plain_loop_and_float64(bandwidth, segments, frames):
    """Every bandwidth the kernel is built for that MLPG's windows give,
    segment counts from one to the kernel's 32, T' below S * BW (3, 17),
    and the B16 T1024 one with padding 100 (1224). However the rows are
    split, the substitutions are those of the loop's factor: within an f32
    ulp of the largest |x| of float64 triangular solves with it."""
    b, bands, valid, plain, exact = _case(bandwidth, frames)
    got = partition_solve(b, bands, valid, segments)
    assert torch.isfinite(got).all()
    unsplit = factor_solve_f64(b, bands, valid)
    ulp = float(np.spacing(np.float32(np.abs(unsplit).max())))
    assert np.abs(got.double().numpy() - unsplit).max() <= ulp
    assert_near_plain(got, plain)
    assert_near_float64(got.numpy(), plain.numpy(), exact)
    assert (got[:, 2:4] == 0).all()


def backward_error(x, b, bands):
    """Each lane's normwise backward error ``max |P x - b| / (max_i sum_j
    |P_ij| max |x|)``, in float64, over all rows."""
    bw = bands.shape[0] - 1
    x, b, bands = (t.double().numpy() for t in (x, b, bands))
    res = bands[0] * x - b
    row_sum = np.abs(bands[0]).copy()
    for mm in range(1, bw + 1):
        res[:-mm] += bands[mm, :-mm] * x[mm:]
        res[mm:] += bands[mm, :-mm] * x[:-mm]
        row_sum[:-mm] += np.abs(bands[mm, :-mm])
        row_sum[mm:] += np.abs(bands[mm, :-mm])
    return np.abs(res).max(0) / (row_sum.max(0) * np.abs(x).max(0))


@pytest.mark.parametrize('segments', [4, 32])
def test_partition_solve_on_a_system_of_random_couplings(segments):
    """A banded SPD system ``L L^T`` of random factors (off-diagonals of
    either sign, not MLPG's; condition numbers 70-330), all rows valid, BW
    3 (no MLPG window gives it, but the kernel is built for it). The method
    is backward-stable: its backward error within twice the plain loop's
    plus one f32 epsilon (both below one epsilon here), and its mean error
    against float64 within twice the loop's (here 0.93x; the max 1.09x)."""
    rng = np.random.default_rng(3)
    frames, lanes, bw = 300, 5, 3
    bands = np.zeros((bw + 1, frames, lanes))
    for lane in range(lanes):
        low = sum(np.diag(rng.uniform(0.5, 1.5, frames - mm) if mm == 0
                          else rng.normal(scale=0.3, size=frames - mm), -mm) for mm in range(bw + 1))
        p = low @ low.T
        for mm in range(bw + 1):
            bands[mm, :frames - mm, lane] = np.diag(p, mm)
    b = torch.from_numpy(rng.normal(size=(frames, lanes)).astype(np.float32))
    bands = torch.from_numpy(bands.astype(np.float32))
    valid = torch.full((lanes,), frames)
    plain = tmlpg._banded_cholesky_solve(b, list(bands.unbind(0)), bw)
    got = partition_solve(b, bands, valid, segments)
    eps = float(np.finfo(np.float32).eps)
    assert (backward_error(got, b, bands) <= 2 * backward_error(plain, b, bands) + eps).all()
    exact = banded_f64(b, bands, valid)
    err, own = np.abs(got.numpy() - exact), np.abs(plain.numpy() - exact)
    assert err.mean() <= 2 * own.mean()


VARIANCE_SHAPES = ['global', 'per_frame', 'per_item']


def _mlpg_inputs(seed, windows, variance_shape, batch=3, frames=40, feat_dim=4):
    rng = np.random.default_rng(seed)
    width = len(windows) * feat_dim
    means = rng.normal(size=(batch, frames, width)).astype(np.float32)
    shape = {'global': (width,), 'per_frame': (frames, width),
             'per_item': (batch, frames, width)}[variance_shape]
    variances = rng.uniform(0.2, 2.0, size=shape).astype(np.float32)
    seq_len = np.array([frames, frames - 13, 1][:batch])
    return means, variances, seq_len


def _plain_mlpg(means, variances, windows, padding_size, seq_len):
    """The plain path: the banded systems, the plain loop, the unpad."""
    batch, frames, width = means.shape
    b, bands, seq_len = tmlpg.banded_system(means, variances, windows, padding_size, seq_len)
    x = tmlpg._banded_cholesky_solve(b, list(bands.unbind(0)), bands.shape[0] - 1)
    x = x.reshape(-1, batch, width // len(windows)).permute(1, 0, 2)
    x = x[:, padding_size:padding_size + frames]
    mask = (torch.arange(frames)[None, :] < seq_len[:, None])[:, :, None]
    return torch.where(mask, x, 0.)


@pytest.mark.parametrize('variance_shape', VARIANCE_SHAPES)
@pytest.mark.parametrize('padding_size', [0, 100])
@pytest.mark.parametrize('bandwidth', [2, 4], ids=['default_windows', 'custom_windows'])
def test_the_op_is_the_plain_path_and_holds_to_jax(bandwidth, padding_size, variance_shape):
    """``morgana::mlpg`` on the CPU gives the plain path's bits, and holds
    to the JAX package's mlpg and the float64 solve as ``mlpg`` does in
    tests/test_torch_ops.py (items of 40, 27 and 1 frames); with an item of
    length 0 it gives the plain path's bits too, all zeros in that item."""
    windows = WINDOWS[bandwidth]
    means, variances, seq_len = _mlpg_inputs(bandwidth + padding_size, windows, variance_shape)
    mt, vt, st = (torch.from_numpy(a) for a in (means, variances, seq_len))
    got = tmlpg.mlpg(mt, vt, windows, padding_size, st)
    assert torch.equal(got, _plain_mlpg(mt, vt, windows, padding_size, st))
    want = np.asarray(jmlpg(jnp.asarray(means), jnp.asarray(variances), windows=windows,
                            padding_size=padding_size, seq_len=jnp.asarray(seq_len)))
    exact = mlpg_numpy(means, variances, windows, padding_size=padding_size, seq_len=seq_len)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=JAX_RTOL)
    np.testing.assert_allclose(got.numpy() / scale, exact / scale, atol=F64_RTOL)
    st[1] = 0
    got = tmlpg.mlpg(mt, vt, windows, padding_size, st)
    assert torch.equal(got, _plain_mlpg(mt, vt, windows, padding_size, st))
    assert (got[1] == 0).all()


@pytest.mark.parametrize('padding_size', [0, 100])
def test_partition_solve_of_mlpg_systems_at_the_ops_lengths(padding_size):
    """The model on the systems ``morgana::mlpg`` builds (valid lengths
    ``seq_len + 2 * padding``, one item of length 0), through the op's
    unpad: within MLPG_RTOL of the op's CPU output."""
    windows = WINDOWS[2]
    means, variances, seq_len = _mlpg_inputs(7, windows, 'per_item')
    seq_len[1] = 0
    mt, vt, st = (torch.from_numpy(a) for a in (means, variances, seq_len))
    b, bands, _ = tmlpg.banded_system(mt, vt, windows, padding_size, st)
    valid = torch.repeat_interleave(torch.where(st > 0, st + 2 * padding_size, 0), 4)
    x = partition_solve(b, bands, valid, 32)
    x = x.reshape(-1, 3, 4).permute(1, 0, 2)[:, padding_size:padding_size + 40]
    x = torch.where((torch.arange(40)[None, :] < st[:, None])[:, :, None], x, 0.)
    assert_near_plain(x, tmlpg.mlpg(mt, vt, windows, padding_size, st))


def test_segment_lengths():
    """m = max(ceil(n / S), BW, 1) rows a segment, ceil(n / m) segments."""
    for n, bw, segments, want in ((1224, 2, 32, (39, 32)), (17, 4, 32, (4, 5)),
                                  (3, 2, 32, (2, 2)), (0, 2, 32, (2, 0)), (5, 0, 32, (1, 5))):
        m = max(math.ceil(n / segments), bw, 1)
        assert (m, math.ceil(n / m)) == want
