"""Builds the port's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/<name>.<hash>.so`` inside this
package (a directory ``.gitignore`` lists), and loaded with ``ctypes``. The
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited source is rebuilt and an unchanged one is reused. Nothing is fetched: the
CUDA toolkit is found through ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``.
The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
is kept beside each library as ``<name>.<hash>.log``.

A *variant* is the same source built with extra defines into a library of
its own (``<name>-<variant>.<hash>.so``): ``step_split`` compiles the LSTM
kernels' per-step clock records, which the main path's libraries never
contain.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ['CSRC_DIR', 'BUILD_DIR', 'VARIANTS', 'build', 'kernel_names', 'load']

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
# name -> the extra nvcc flags of that variant
VARIANTS = {'step_split': ('-DMORGANA_STEP_SPLIT=1',)}

_LOCK = threading.Lock()
_LIBS = {}


def _nvcc():
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    candidates += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH): '
                       'the CUDA kernels are built from csrc/ on the machine '
                       'that has the GPU')


def _flags(variant):
    return NVCC_FLAGS + (VARIANTS[variant] if variant else ())


def _target(name, variant=None):
    source = os.path.join(CSRC_DIR, f'{name}.cu')
    digest = hashlib.sha256()
    # The shared headers count too: a source that includes one is rebuilt
    # when it changes.
    for path in [source] + sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh'))):
        with open(path, 'rb') as f:
            digest.update(f.read())
    digest.update(' '.join(_flags(variant)).encode())
    stem = f'{name}-{variant}' if variant else name
    return source, os.path.join(BUILD_DIR, f'{stem}.{digest.hexdigest()[:16]}.so')


def kernel_names():
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, '*.cu')))


def build(names=None, variant=None):
    """Compiles every kernel in ``names`` (default: all of ``csrc/*.cu``)
    whose library is missing, one ``nvcc`` each, all started together, with
    ``variant``'s flags if one is named. Returns ``{name: library path}``;
    raises with the compiler's output if any build fails."""
    names = kernel_names() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, running = {}, []
    for name in names:
        source, target = _target(name, variant)
        paths[name] = target
        if os.path.exists(target):
            continue
        tmp = f'{target}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *_flags(variant), '-o', tmp, source]
        running.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, target, tmp, proc in running:
        log, _ = proc.communicate()
        with open(os.path.splitext(target)[0] + '.log', 'w') as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failures))
    return paths


def load(name, variant=None):
    """The ``ctypes`` library of kernel ``name`` (its ``variant``), built on
    first use."""
    with _LOCK:
        if (name, variant) not in _LIBS:
            _LIBS[name, variant] = ctypes.CDLL(build([name], variant)[name])
        return _LIBS[name, variant]
