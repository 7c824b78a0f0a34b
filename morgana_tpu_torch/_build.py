"""Builds the port's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/<name>.<hash>.so`` inside this
package (a directory ``.gitignore`` lists), and loaded with ``ctypes``. The
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited source is rebuilt and an unchanged one is reused. Nothing is fetched: the
CUDA toolkit is found through ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``.
The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
is kept beside each library as ``<name>.<hash>.log``.

The host's C++ sources (the vocoder's ``vocoder/csrc/world_synth.cpp``) take
the g++ route, :func:`build_cxx`: ``g++ -O3 -march=native`` into
``build/<name>.<hash>.so``, the hash also covering the host's CPU (model and
flags), since ``-march=native`` builds for it.

The build directory is a cache: ``--compilation_cache_dir`` (the serving
command line, :func:`set_build_dir`) names another, shared between
processes, so that a new process finds the libraries there and runs no
``nvcc`` (the port's counterpart of the JAX package's persistent XLA
compilation cache). :data:`nvcc_runs` and :data:`cxx_runs` count the
compilers this process started.

A *variant* is the same source built with extra defines into a library of
its own (``<name>-<variant>.<hash>.so``): ``step_split`` compiles the LSTM
kernels' per-step clock records, ``mlpg_check`` MLPG's check of its root and
reciprocal against the IEEE ones; the main path's libraries contain
neither.
"""
import ctypes
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import threading

__all__ = ['CSRC_DIR', 'BUILD_DIR', 'VARIANTS', 'build', 'build_cxx', 'kernel_names',
           'load', 'set_build_dir', 'nvcc_runs', 'cxx_runs']

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
# -march=native: the JAX package builds its copy of world_synth.cpp so, and
# without it g++ contracts no multiply-adds, so the two libraries would
# differ in the last bits of a sample.
CXX_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-std=c++17', '-pthread')
# name -> the extra nvcc flags of that variant
VARIANTS = {'step_split': ('-DMORGANA_STEP_SPLIT=1',),
            'mlpg_check': ('-DMORGANA_MLPG_CHECK=1',)}

_LOCK = threading.Lock()
_LIBS = {}

# The nvcc and g++ processes this process started.
nvcc_runs = 0
cxx_runs = 0


def set_build_dir(path):
    """Builds and finds the libraries in ``path`` from now on (created when
    missing); a library already loaded stays in use."""
    global BUILD_DIR
    with _LOCK:
        BUILD_DIR = os.path.abspath(path)
        os.makedirs(BUILD_DIR, exist_ok=True)


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
    global nvcc_runs
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
        nvcc_runs += 1
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


def _host_cpu():
    """The CPU that ``-march=native`` builds for: the machine, and the model
    name and flags of ``/proc/cpuinfo`` where there is one."""
    lines = []
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('model name', 'flags')):
                    lines.append(line)
                if len(lines) == 2:
                    break
    except OSError:
        pass
    return platform.machine() + ''.join(lines)


def build_cxx(name, source):
    """Compiles the C++ source ``source`` (a plain C interface) with g++ into
    ``build/<name>.<hash>.so`` unless it is there. Returns the path; raises
    ``RuntimeError`` with the compiler's output if g++ is missing or
    fails."""
    with open(source, 'rb') as f:
        digest = hashlib.sha256(f.read())
    digest.update(' '.join(CXX_FLAGS).encode())
    digest.update(_host_cpu().encode())
    target = os.path.join(BUILD_DIR, f'{name}.{digest.hexdigest()[:16]}.so')
    if os.path.exists(target):
        return target
    global cxx_runs
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{target}.{os.getpid()}.tmp'
    cxx_runs += 1
    try:
        proc = subprocess.run(['g++', *CXX_FLAGS, source, '-o', tmp], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f'{name}: g++ did not run ({e})') from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f'{name}: g++ exited {proc.returncode}\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, target)
    return target
