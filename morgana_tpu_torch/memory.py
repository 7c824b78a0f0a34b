"""Device memory: the train step's measured peak and the batch-size search
(counterpart of ``morgana_tpu/memory.py``).

The JAX package reads a train step's peak from the compiler's buffer
assignment before any step runs. The port compiles nothing, so it measures:
a probe runs one full train step (forward, backward and the optimiser) after
``torch.cuda.reset_peak_memory_stats`` and reads
``torch.cuda.max_memory_allocated`` after it. A probe that raises counts as
over the limit: ``torch.cuda.OutOfMemoryError`` (then ``empty_cache``), or a
kernel that refuses the batch before it launches (K1/K2 take B <= 256,
``ops/lstm.py``), which the search reports as such.

:func:`batch_granularity`, :func:`batch_shapes_at`,
:func:`find_max_batch_size` and :func:`format_report`'s layout are the JAX
package's (``memory.py:142``, ``:161``, ``:220``, ``:289``).
"""
import collections

import numpy as np
import torch

__all__ = ['ShapeDtype', 'batch_granularity', 'batch_shapes_at', 'batch_at',
           'find_max_batch_size', 'search_train_batch_size', 'measure_train_step',
           'state_bytes', 'device_memory_stats', 'format_report', 'probe_failure',
           'MemoryAnalysisUnavailable']

#: A feature's shape and dtype (the port's stand-in for ``jax.ShapeDtypeStruct``).
ShapeDtype = collections.namedtuple('ShapeDtype', ['shape', 'dtype'])


class MemoryAnalysisUnavailable(RuntimeError):
    """The device reports no memory statistics (a CPU run): the search cannot
    run, which is not the same as nothing fitting."""


def _numeric(features):
    return {key: value for key, value in features.items()
            if isinstance(value, np.ndarray) and value.dtype.kind in 'fiub'}


def batch_granularity(features):
    """The number of batch-axis shards of ``features``, which probe sizes
    must be multiples of: 1, since the port does not shard a batch yet (the
    JAX package reads its ``NamedSharding``s)."""
    del features
    return 1


def batch_shapes_at(features, batch_size):
    """``{key: ShapeDtype}`` of a collated batch's numeric arrays with the
    leading (batch) axis set to ``batch_size``; the time and feature axes stay
    the first batch's."""
    return {key: ShapeDtype((int(batch_size),) + tuple(value.shape[1:]), value.dtype)
            for key, value in _numeric(features).items()}


def batch_at(features, batch_size):
    """A collated batch of ``batch_size`` rows with :func:`batch_shapes_at`'s
    shapes: the rows of ``features`` repeated in turn (names and other host
    values left out)."""
    shapes = batch_shapes_at(features, batch_size)
    rows = next(iter(_numeric(features).values())).shape[0]
    take = np.arange(batch_size) % rows
    return {key: np.ascontiguousarray(features[key][take]) for key in shapes}


def find_max_batch_size(peak_bytes_fn, limit_bytes, start=1, max_batch=4096, granularity=1):
    """The largest batch size in ``[start, max_batch]`` whose peak fits
    ``limit_bytes`` (``memory.py:220``): doubling to bracket the boundary,
    then a binary search inside it. ``peak_bytes_fn(b)`` gives the peak of a
    probe at ``b``; one that raises counts as over the limit, except
    :class:`MemoryAnalysisUnavailable`, which propagates. Returns ``(best or
    None, probes)``, ``probes`` mapping each size probed to its peak (None
    when the probe raised)."""
    if start < 1 or max_batch < start:
        raise ValueError(f'need 1 <= start <= max_batch, got start={start} '
                         f'max_batch={max_batch}')
    g = max(int(granularity), 1)
    k_start = max((start + g - 1) // g, 1)
    k_max = max_batch // g
    if k_max < k_start:
        raise ValueError(f'granularity {g} leaves no probe sizes in [{start}, {max_batch}]')
    probes = {}

    def fits(k):
        b = k * g
        if b not in probes:
            try:
                probes[b] = int(peak_bytes_fn(b))
            except MemoryAnalysisUnavailable:
                raise
            except Exception:  # noqa: BLE001 - a failing probe is the signal
                probes[b] = None
        return probes[b] is not None and probes[b] <= limit_bytes

    if not fits(k_start):
        return None, probes
    lo, hi = k_start, None
    while hi is None and lo < k_max:
        nxt = min(lo * 2, k_max)
        if fits(nxt):
            lo = nxt
        else:
            hi = nxt
    while hi is not None and hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo * g, probes


def state_bytes(loop):
    """Bytes the train loop holds between steps: ``parameters``,
    ``optimizer_state`` (the chain's moments and traces), ``gradients`` (one
    a parameter) and ``accumulator`` (the f32 gradient sums, once gradient
    accumulation has made them)."""
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    params = list(loop.params.values())
    opt = [t for st in loop.opt_state if st for v in st.values() if isinstance(v, list)
           for t in v]
    return {'parameters': nbytes(params), 'optimizer_state': nbytes(opt),
            'gradients': nbytes(params), 'accumulator': nbytes(loop._acc_grads or [])}


def device_memory_stats(device):
    """``torch.cuda.memory_stats``' byte counters of ``device`` (allocated
    and reserved, current and peak), or None for a CPU device."""
    if torch.device(device).type != 'cuda':
        return None
    stats = torch.cuda.memory_stats(device)
    return {key: int(stats[key]) for key in ('allocated_bytes.all.current',
                                             'allocated_bytes.all.peak',
                                             'reserved_bytes.all.current',
                                             'reserved_bytes.all.peak') if key in stats}


def measure_train_step(loop, features, lr=0.0):
    """One full train step of ``loop`` on ``features`` (closing any
    accumulation cycle), with the device's peak reset before it; returns the
    bytes ``torch.cuda.max_memory_allocated`` read after it. Raises
    :class:`MemoryAnalysisUnavailable` on the CPU. With ``lr`` 0 the
    parameters stay as they are (the optimiser state moves)."""
    device = loop.device
    if device.type != 'cuda':
        raise MemoryAnalysisUnavailable(f'{device} reports no allocator peak; the batch-size '
                                        'search measures on the GPU')
    for p in loop.params.values():
        p.grad = None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    loop.train_step(features, lr, force_apply=True)
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def probe_failure(exc):
    """Why a probe raised, in words: the allocator ran out, or a kernel
    refused the batch before its launch."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return 'out of memory'
    if isinstance(exc, ValueError) and 'kernels take' in str(exc):
        return f"the kernel's batch limit ({exc})"
    return f'{type(exc).__name__}: {exc}'


def search_train_batch_size(loop, features, limit_bytes, start=1, max_batch=4096):
    """:func:`find_max_batch_size` over :func:`measure_train_step` at
    :func:`batch_at` sizes of the first batch ``features`` (its padded
    length held). Returns ``(best, probes, failures)``, ``failures`` mapping
    each size whose probe raised to :func:`probe_failure`'s words."""
    failures = {}

    def peak(b):
        try:
            return measure_train_step(loop, batch_at(features, b))
        except MemoryAnalysisUnavailable:
            raise
        except Exception as exc:  # noqa: BLE001 - recorded, then counted as over the limit
            failures[b] = probe_failure(exc)
            raise
        finally:
            if loop.device.type == 'cuda':
                for p in loop.params.values():
                    p.grad = None
                torch.cuda.empty_cache()

    best, probes = find_max_batch_size(peak, limit_bytes, start=start, max_batch=max_batch,
                                       granularity=batch_granularity(features))
    return best, probes, failures


def _fmt_bytes(n):
    for unit in ('B', 'KiB', 'MiB', 'GiB', 'TiB'):
        if abs(n) < 1024 or unit == 'TiB':
            return f'{n:.2f} {unit}' if unit != 'B' else f'{n:d} B'
        n /= 1024.0
    return f'{n:.2f} TiB'


def format_report(program, device_stats=None, batch_shapes=None, header=''):
    """The ``memory_report.txt`` body (``memory.py:289``): the batch's
    shapes, the train step's bytes (``program``: ``{name}_bytes`` of
    :func:`state_bytes`' names, ``peak_bytes`` and ``step_peak_above_state_bytes``)
    and the allocator's counters."""
    lines = []
    if header:
        lines += [header, '=' * len(header), '']
    if batch_shapes:
        lines.append('Batch shapes (the measured step is specific to these; longer '
                     'batches take more):')
        for key, shape in sorted(batch_shapes.items()):
            lines.append(f'  {key}: {tuple(shape)}')
        lines.append('')
    if program:
        lines.append('Train step — measured on the device (torch.cuda.max_memory_allocated '
                     'after reset_peak_memory_stats):')
        for name in ('parameters', 'optimizer_state', 'gradients', 'accumulator',
                     'step_peak_above_state', 'peak'):
            key = name + '_bytes'
            if key in program:
                lines.append(f'  {name:>21}: {_fmt_bytes(program[key]):>12}')
        lines.append('')
        lines.append('  peak = the most the allocator held during the step; '
                     'step_peak_above_state = peak less parameters, optimizer state, '
                     'gradients and accumulator.')
    else:
        lines.append('This device reports no allocator peak (a CPU run): nothing measured.')
    lines.append('')
    if device_stats:
        lines.append('Device allocator (live, includes params/optimiser state and anything '
                     'else resident):')
        for key, value in device_stats.items():
            lines.append(f'  {key:>28}: {_fmt_bytes(value):>12}')
    else:
        lines.append('Device allocator stats: not reported by this device (CPU).')
    return '\n'.join(lines) + '\n'
