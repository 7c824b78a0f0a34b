"""Deployment bundles of the port (``morgana_tpu_torch.export``) on the CPU,
mirroring ``tests/test_export.py``: one ``torch.export`` program per padded
batch shape with the parameters as inputs, ``params.npz`` under the JAX
names, and the JAX bundle's manifest.

Small voices, seeded: ``F0Model`` at full width (3 x GRU(64)),
``LSTMAcousticModel`` cut to 2 x LSTM(32) and ``TransformerAcousticModel``
to 1 block of 64 wide, on the ``voice_data`` corpus at B=2. ``ExportedVoice``
gives the engine's outputs exactly (the same plain versions run on the same
inputs, tolerance 0), also quantized to int8 and in a process that never
imports the model's module; its manifest's input signatures are the JAX
package's ``export_bundle``'s for the same checkpoint and data.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu.export import export_bundle as jexport_bundle
from morgana_tpu.serve import InferenceEngine as JEngine

from morgana_tpu_torch import _build
from morgana_tpu_torch.export import ExportedVoice, export_bundle
from morgana_tpu_torch.models.f0_test_model import F0Model
from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel
from morgana_tpu_torch.serve import InferenceEngine, numeric_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'models'))
try:
    from f0_test_model import F0Model as JF0
finally:
    sys.path.pop(0)

ID_LIST = 'test/test_file_id_list.scp'
# name: (model class, model kwargs, the custom ops one batch runs)
VOICES = {
    'f0': (F0Model, {}, {'gru_fwd': 3, 'mlpg': 1}),
    'lstm': (LSTMAcousticModel, {'num_layers': 2, 'hidden_size': 32},
             {'lstm_fwd': 2, 'mlpg': 1}),
    'transformer': (TransformerAcousticModel, {'num_layers': 1, 'd_model': 64},
                    {'attn_fwd': 1, 'mlpg': 1}),
}


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''),
                JAX_PLATFORMS='cpu')


@pytest.fixture(scope='module')
def checkpoints(voice_data, tmp_path_factory):
    """A seeded epoch_0.npz of each voice (the F0 one made by the JAX model)."""
    base = tmp_path_factory.mktemp('export_ckpts')
    out = {}
    for name, (cls, kwargs, _) in VOICES.items():
        torch.manual_seed(7)
        out[name] = cls(**kwargs).save_parameters(str(base / name), 0)
    jnn.manual_seed(5)
    out['f0'] = JF0().save_parameters(str(base / 'jax_f0'), 0)
    return out


def _engine(voice_data, checkpoints, name, quantize=None):
    cls, kwargs, _ = VOICES[name]
    return InferenceEngine(cls, checkpoints[name], data_root=voice_data['data_root'],
                           model_kwargs=kwargs, device='cpu', batch_size=2, quantize=quantize)


@pytest.fixture(scope='module', params=[(name, None) for name in VOICES] + [('f0', 'int8'),
                                                                          ('lstm', 'int8')],
                ids=lambda p: p[0] + ('' if p[1] is None else f'-{p[1]}'))
def bundle(request, voice_data, checkpoints, tmp_path_factory):
    name, quantize = request.param
    engine = _engine(voice_data, checkpoints, name, quantize)
    out_dir = str(tmp_path_factory.mktemp(f'bundle_{name}'))
    manifest = export_bundle(engine, out_dir, data_dir='test', id_list=ID_LIST,
                             model_spec=f'{VOICES[name][0].__module__}:{VOICES[name][0].__name__}')
    return {'name': name, 'dir': out_dir, 'manifest': manifest, 'engine': engine,
            'quantize': quantize}


def test_manifest_and_files(bundle):
    manifest = bundle['manifest']
    assert sorted(manifest) == ['batch_size', 'checkpoint', 'model', 'params_file', 'programs',
                                'quantize']
    assert manifest['params_file'] == 'params.npz' and manifest['quantize'] == bundle['quantize']
    assert manifest['programs']
    for prog in manifest['programs']:
        assert os.path.isfile(os.path.join(bundle['dir'], prog['file']))
        assert prog['file'] == f"predict_b{prog['batch']}_t{prog['max_frames']}.pt2"
        names = {e['name'] for e in prog['inputs']}
        assert 'normalised_lab' in names and 'n_frames' in names
    with open(os.path.join(bundle['dir'], 'manifest.json')) as f:
        assert json.load(f) == manifest


def test_programs_take_the_parameters_as_inputs(bundle):
    """No parameter, buffer or example input is saved in a program: its
    constants are the normalisers' statistics; every kernel call is one
    morgana:: node (per layer, and one for the whole MLPG)."""
    params = np.load(os.path.join(bundle['dir'], 'params.npz'))
    for prog in bundle['manifest']['programs']:
        program = torch.export.load(os.path.join(bundle['dir'], prog['file']))
        assert not program.state_dict and not program.graph_signature.parameters
        assert not program.graph_signature.buffers and program.example_inputs is None
        assert sum(c.numel() for c in program.constants.values()) < 1000
        inputs = [spec for spec in program.graph_signature.input_specs
                  if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT]
        assert len(inputs) == len([k for k in params.files if not k.startswith('__')]) + \
            len(prog['inputs'])
        ops = {}
        for node in program.graph.nodes:
            if node.op == 'call_function' and str(node.target).startswith('morgana.'):
                op = str(node.target).split('.')[1]
                ops[op] = ops.get(op, 0) + 1
        assert ops == VOICES[bundle['name']][2]


def test_bundle_matches_engine(bundle):
    """ExportedVoice (no model class involved) gives the engine's predict
    outputs exactly on every exported shape; staged metrics: none, as the
    engine's models stage none in predict."""
    engine = bundle['engine']
    voice = ExportedVoice(bundle['dir'], device='cpu')
    runs = 0
    for features in engine._loader('test', id_list=ID_LIST):
        staged, got = voice.run(features)
        want = engine.predict_batch(features)
        assert staged == {} and sorted(got) == sorted(want)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
        runs += 1
    assert runs == len(bundle['manifest']['programs'])


# The op nodes a bf16 bundle holds: the recurrences with compute_bf16 set,
# attention on bf16 q, k and v.
BF16_NODE = {'lstm_fwd': lambda node: node.args[5] is True,
             'gru_fwd': lambda node: node.args[5] is True,
             'attn_fwd': lambda node: node.args[0].meta['val'].dtype == torch.bfloat16}


@pytest.mark.parametrize('name', list(VOICES))
def test_bf16_bundle_matches_the_bf16_engine(name, voice_data, checkpoints, tmp_path):
    """A bundle exported under --compute_dtype bfloat16 holds the bf16 op
    nodes and, run by ExportedVoice in f32 (the program carries its dtype),
    gives the bf16 engine's outputs exactly on every exported shape, which
    differ from the f32 engine's."""
    from morgana_tpu_torch import nn as tnn
    f32 = _engine(voice_data, checkpoints, name)
    try:
        cls, kwargs, _ = VOICES[name]
        engine = InferenceEngine(cls, checkpoints[name], data_root=voice_data['data_root'],
                                 model_kwargs=kwargs, device='cpu', batch_size=2,
                                 compute_dtype='bfloat16')
        manifest = export_bundle(engine, str(tmp_path), data_dir='test', id_list=ID_LIST)
        batches = list(engine._loader('test', id_list=ID_LIST))
        wants = [engine.predict_batch(features) for features in batches]
    finally:
        tnn.set_default_compute_dtype(None)
    for prog in manifest['programs']:
        graph = torch.export.load(str(tmp_path / prog['file'])).graph
        nodes = [n for n in graph.nodes if str(n.target).startswith('morgana.')]
        kernels = [n for n in nodes if str(n.target).split('.')[1] in BF16_NODE]
        assert kernels and all(BF16_NODE[str(n.target).split('.')[1]](n) for n in kernels)
    voice = ExportedVoice(str(tmp_path), device='cpu')
    for features, want in zip(batches, wants):
        _, got = voice.run(features)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
        assert not torch.equal(got['vuv'] if 'vuv' in want else got[sorted(want)[0]],
                               f32.predict_batch(features)['vuv' if 'vuv' in want
                                                           else sorted(want)[0]])
    assert len(batches) == len(manifest['programs'])


def test_params_npz_holds_the_served_leaves(bundle, checkpoints):
    """params.npz: the checkpoint's arrays by the JAX names, or for an int8
    voice the quantize module's checkpoint format (the .q and .scale
    leaves), which the engine serves as it is."""
    path = os.path.join(bundle['dir'], 'params.npz')
    ckpt = np.load(checkpoints[bundle['name']])
    with np.load(path) as saved:
        if bundle['quantize'] is None:
            assert sorted(saved.files) == sorted(ckpt.files)
            for key in ckpt.files:
                np.testing.assert_array_equal(saved[key], ckpt[key])
        else:
            assert '__quantized_format__' in saved.files
            assert any(k.endswith('.q') and saved[k].dtype == np.int8 for k in saved.files)
    if bundle['quantize'] is not None:
        engine = bundle['engine']
        served = InferenceEngine(type(engine.model), path, data_root=engine.data_root,
                                 model_kwargs=VOICES[bundle['name']][1], device='cpu')
        assert served.quantized
        for key, value in engine.program_params().items():
            torch.testing.assert_close(served.program_params()[key], value, rtol=0, atol=0)


def test_program_runs_other_parameters(bundle, voice_data, tmp_path):
    """A program takes whatever parameters it is given: with a second
    checkpoint's, it gives that checkpoint's engine's outputs."""
    engine = bundle['engine']
    cls, kwargs, _ = VOICES[bundle['name']]
    torch.manual_seed(99)
    other = cls(**kwargs).save_parameters(str(tmp_path), 0)
    engine2 = InferenceEngine(cls, other, data_root=voice_data['data_root'],
                              model_kwargs=kwargs, device='cpu', batch_size=2,
                              quantize=bundle['quantize'])
    voice = ExportedVoice(bundle['dir'], device='cpu')
    voice.params = engine2.program_params()
    features = next(iter(engine._loader('test', id_list=ID_LIST)))
    _, got = voice.run(features)
    want = engine2.predict_batch(features)
    before = engine.predict_batch(features)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    assert any(not torch.equal(want[k], before[k]) for k in want)


def test_unknown_shape_reports_available(bundle, rng):
    voice = ExportedVoice(bundle['dir'], device='cpu')
    bad = {'normalised_lab': rng.random((1, 3, 600), np.float32),
           'n_frames': np.array([3.], np.float32)}
    with pytest.raises(ValueError, match='no exported program'):
        voice.run(bad)


def test_empty_split_raises(bundle, tmp_path):
    with pytest.raises(ValueError, match='nothing to export|non-empty file_ids'):
        export_bundle(bundle['engine'], str(tmp_path / 'b2'), data_dir='test', file_ids=[])


def test_manifest_inputs_match_the_jax_bundle(voice_data, checkpoints, tmp_path):
    """The JAX package's export_bundle of its F0Model and the port's of its
    own, on the same checkpoint and data at B=2: the same programs' names,
    shapes and input signatures, and the same manifest keys."""
    root = voice_data['data_root']
    jengine = JEngine(JF0, checkpoints['f0'], data_root=root, batch_size=2, device='cpu')
    want = jexport_bundle(jengine, str(tmp_path / 'jax'), data_dir='test', id_list=ID_LIST)
    got = export_bundle(_engine(voice_data, checkpoints, 'f0'), str(tmp_path / 'port'),
                        data_dir='test', id_list=ID_LIST)
    assert sorted(got) == sorted(want)
    assert [(p['batch'], p['max_frames'], p['inputs']) for p in got['programs']] == \
        [(p['batch'], p['max_frames'], p['inputs']) for p in want['programs']]
    assert [os.path.splitext(p['file'])[0] for p in got['programs']] == \
        [os.path.splitext(p['file'])[0] for p in want['programs']]


RUN_BUNDLE = r'''
import json, sys
import numpy as np
from morgana_tpu_torch.export import ExportedVoice
bundle, batch_file, out_file = sys.argv[1:]
voice = ExportedVoice(bundle, device='cpu')
with np.load(batch_file) as data:
    batch = {k: data[k] for k in data.files}
staged, outputs = voice.run(batch)
np.savez(out_file, **{k: v.numpy() for k, v in outputs.items()})
print(json.dumps({'models': sorted(m for m in sys.modules if '.models' in m or m == 'models'),
                  'jax': 'jax' in sys.modules, 'staged': staged}))
'''


def test_bundle_runs_where_the_model_is_never_imported(voice_data, checkpoints, tmp_path):
    """A fresh process loads the LSTM bundle with ExportedVoice alone: no
    module of a model (nor JAX) is imported, and it gives the engine's
    outputs."""
    engine = _engine(voice_data, checkpoints, 'lstm')
    export_bundle(engine, str(tmp_path / 'b'), data_dir='test', id_list=ID_LIST)
    features = next(iter(engine._loader('test', id_list=ID_LIST)))
    np.savez(tmp_path / 'batch.npz', **numeric_features(features))
    proc = subprocess.run([sys.executable, '-c', RUN_BUNDLE, str(tmp_path / 'b'),
                           str(tmp_path / 'batch.npz'), str(tmp_path / 'out.npz')],
                          capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {'models': [], 'jax': False, 'staged': {}}
    want = engine.predict_batch(features)
    with np.load(tmp_path / 'out.npz') as got:
        assert sorted(got.files) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key].numpy())


def test_cli_end_to_end(voice_data, checkpoints, tmp_path):
    out_dir = str(tmp_path / 'bundle')
    proc = subprocess.run(
        [sys.executable, '-m', 'morgana_tpu_torch.export',
         '--model', 'morgana_tpu_torch.models.f0_test_model:F0Model',
         '--checkpoint_path', checkpoints['f0'], '--data_root', voice_data['data_root'],
         '--data_dir', 'test', '--out_dir', out_dir, '--batch_size', '2', '--device', 'cpu',
         '--quantize', 'int8'],
        capture_output=True, text=True, env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats['programs'] >= 1 and stats['quantized'] is True
    voice = ExportedVoice(out_dir, device='cpu')
    assert voice.signatures()
    assert voice.manifest['model'].endswith('F0Model')


@pytest.mark.parametrize('argv,message', [
    (['--compute_dtype', 'bfloat16'], 'ROADMAP.md'),
    (['--device', 'tpu'], 'invalid choice')], ids=['compute_dtype', 'device'])
def test_cli_refuses(argv, message, capsys):
    """--device tpu is an argparse error. --compute_dtype is ported now:
    'bfloat16' is accepted (the command then fails to import its model,
    m:C), and a dtype the port lacks (float16) is an argparse error naming
    ROADMAP.md."""
    from morgana_tpu_torch.export import main
    base = ['--model', 'm:C', '--checkpoint_path', 'c.npz', '--out_dir', 'o']
    if argv[0] == '--compute_dtype':
        with pytest.raises(ModuleNotFoundError):
            main(base + argv)
        argv = [argv[0], 'float16']
    with pytest.raises(SystemExit) as exc:
        main(base + argv)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_export_needs_a_gpu_unless_asked_for_the_cpu(voice_data, checkpoints, monkeypatch):
    from morgana_tpu_torch.device import DeviceError
    from morgana_tpu_torch.export import main
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(DeviceError, match="device='cpu'"):
        main(['--model', 'morgana_tpu_torch.models.f0_test_model:F0Model', '--checkpoint_path',
              checkpoints['f0'], '--data_root', voice_data['data_root'], '--out_dir', 'o'])


GENERATE = r'''
import json, sys
from morgana_tpu_torch import _build, serve
serve.main(sys.argv[1:])
print(json.dumps({'cxx_runs': _build.cxx_runs, 'nvcc_runs': _build.nvcc_runs,
                  'build_dir': _build.BUILD_DIR}))
'''


def test_compilation_cache_dir_is_where_libraries_are_built_and_found(voice_data, checkpoints,
                                                                       tmp_path):
    """The serving command line with --compilation_cache_dir: the first
    process builds the vocoder's native library (on the CPU, the one
    compiled library of the path) into that directory, a second process
    finds it there and runs no compiler."""
    cache = tmp_path / 'cache'
    argv = ['--model', 'morgana_tpu_torch.models.f0_test_model:F0Model', '--checkpoint_path',
            checkpoints['f0'], '--data_root', voice_data['data_root'], '--device', 'cpu',
            '--compilation_cache_dir', str(cache)]
    runs = []
    for i in range(2):
        proc = subprocess.run([sys.executable, '-c', GENERATE, *argv, '--out_dir',
                               str(tmp_path / f'gen{i}')],
                              capture_output=True, text=True, env=_env(), timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        assert os.listdir(tmp_path / f'gen{i}' / 'synth')
    assert [r['cxx_runs'] for r in runs] == [1, 0] and [r['nvcc_runs'] for r in runs] == [0, 0]
    assert runs[0]['build_dir'] == str(cache)
    assert [f for f in os.listdir(cache) if f.startswith('world_synth') and f.endswith('.so')]
