"""Deployment bundles: exported predict programs and their parameters
(counterpart of ``morgana_tpu/export.py``).

``python -m morgana_tpu_torch.export --model module:Class --checkpoint_path
epoch_N.npz --data_root data --out_dir bundle/`` walks the serving data once,
exports the engine's predict step for every distinct padded batch shape it
produces (every length bucket at the chosen batch size) and writes a
self-contained bundle:

* ``manifest.json``: the JAX bundle's schema (model and checkpoint, one entry
  per program with its file, batch size, padded frame count and full input
  signature);
* ``params.npz``: the served parameters, once, under the JAX package's names;
  for an int8 or int4 voice, :mod:`morgana_tpu_torch.quantize`'s packed leaves
  in its checkpoint format;
* ``predict_b{B}_t{T}.pt2``: ``torch.export`` programs
  (:meth:`morgana_tpu_torch.serve.InferenceEngine.export_program`), each
  kernel call one ``morgana::`` custom-op node, the parameters inputs.

:class:`ExportedVoice` runs a bundle without the model's class, data sources
or normaliser files: it needs this package, for the kernels' custom ops, as
the JAX bundle needs jax. A program is specific to the device it was exported
on (``--device``, ``cuda`` by default), as a JAX one to its platform.
``--compute_dtype bfloat16`` exports the bf16 programs: their op nodes are
the bf16 kernels' (``compute_bf16`` set, bf16 q, k and v) and their GEMMs
round their inputs, whatever the compute dtype of the process that runs
them. The manifest records no dtype, as the JAX bundle's does not.

Callers feed :meth:`ExportedVoice.run` batches collated to one of the
manifest's signatures; outputs come back padded (cut each item at its
``n_frames``, as the engine's ``_unpad`` does).
"""
import argparse
import ast
import json
import os
import sys

import numpy as np
import torch

from morgana_tpu_torch import checkpointing
from morgana_tpu_torch import quantize as quantize_mod
from morgana_tpu_torch.device import resolve_device
from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.serve import (InferenceEngine, load_exported_program, load_model_class,
                                     numeric_features, program_inputs)

__all__ = ['export_bundle', 'ExportedVoice', 'main']

_MANIFEST = 'manifest.json'
_PARAMS = 'params.npz'


def _dtype_name(value):
    if isinstance(value, torch.Tensor):
        return str(value.dtype).replace('torch.', '')
    return str(np.asarray(value).dtype)


def _signature(batch):
    """The shape and type signature of a numeric batch (``export.py:43``):
    the key that picks the program that runs it."""
    return tuple(sorted((key, tuple(int(d) for d in value.shape), _dtype_name(value))
                        for key, value in batch.items()))


def _sig_to_json(sig):
    return [{'name': name, 'shape': list(shape), 'dtype': dtype} for name, shape, dtype in sig]


def _sig_from_json(entries):
    return tuple(sorted((e['name'], tuple(int(d) for d in e['shape']), e['dtype'])
                        for e in entries))


def _max_frames(sig):
    dims = [shape[1] for _, shape, _ in sig if len(shape) >= 2]
    return max(dims) if dims else 0


def _save_params(engine, path):
    """``params.npz``: the served version's parameters by JAX name, in the
    quantized checkpoint format when any is quantized."""
    params = engine.served_params()
    if engine.quantized:
        return quantize_mod.save_quantized_checkpoint(params, path)
    return checkpointing.save_state_dict({k: v.detach().cpu().numpy()
                                          for k, v in params.items()}, path)


def export_bundle(engine, out_dir, data_dir='test', id_list=None, file_ids=None,
                  model_spec=None):
    """Exports every distinct padded batch shape that ``data_dir`` produces
    through ``engine`` into ``out_dir`` (``export.py:64``); returns the
    manifest dict."""
    os.makedirs(out_dir, exist_ok=True)
    programs = []
    seen = set()
    for features in engine._loader(data_dir, id_list=id_list, file_ids=file_ids):
        batch = numeric_features(features)
        sig = _signature(batch)
        if sig in seen:
            continue
        seen.add(sig)
        batch_dim = next(iter(batch.values())).shape[0]
        name = f'predict_b{batch_dim}_t{_max_frames(sig)}'
        if any(p['file'].startswith(name) for p in programs):
            name += f'_{len(programs)}'
        file_name = name + '.pt2'
        engine.export_program(features, os.path.join(out_dir, file_name))
        programs.append({'file': file_name, 'batch': int(batch_dim),
                         'max_frames': int(_max_frames(sig)), 'inputs': _sig_to_json(sig)})

    if not programs:
        raise ValueError(f'no batches produced from {data_dir!r}: nothing to export '
                         '(empty id list?)')

    _save_params(engine, os.path.join(out_dir, _PARAMS))
    manifest = {
        'model': model_spec or type(engine.model).__name__,
        'checkpoint': os.path.abspath(engine.checkpoint_path),
        'batch_size': engine.batch_size,
        'quantize': engine._quantize,
        'params_file': _PARAMS,
        'programs': programs,
    }
    with open(os.path.join(out_dir, _MANIFEST), 'w') as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedVoice(object):
    """Runs a bundle written by :func:`export_bundle` or ``python -m
    morgana_tpu_torch.export`` (``export.py:115``): no model code, sources or
    normaliser files needed.

    ``run(batch)`` picks the program whose input signature matches the
    batch's shapes and types exactly and returns ``(staged, outputs)`` as the
    engine's predict step would, tensors on the bundle's device (outputs
    padded; cut them at ``n_frames``). Programs load lazily, once each.

    Parameters
    ----------
    bundle_dir : str
    device : str or torch.device, optional
        Where the parameters and batches go: the device the programs were
        exported on, ``cuda`` by default (``'cpu'`` for a CPU bundle),
        resolved by :func:`~morgana_tpu_torch.device.resolve_device`.
    """

    def __init__(self, bundle_dir, device=None):
        self.bundle_dir = bundle_dir
        self.device = resolve_device(device)
        with open(os.path.join(bundle_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        path = os.path.join(bundle_dir, self.manifest['params_file'])
        if quantize_mod.is_quantized_checkpoint(path):
            params = quantize_mod.load_quantized_checkpoint(path)
        else:
            params = {k: torch.from_numpy(v) for k, v in
                      checkpointing.load_state_dict(path).items()}
        self.params = {k: v.to(self.device) for k, v in program_inputs(params).items()}
        self._by_sig = {_sig_from_json(p['inputs']): p for p in self.manifest['programs']}
        self._loaded = {}

    def signatures(self):
        """The batch signatures this bundle runs (one a program)."""
        return list(self._by_sig)

    def _program(self, sig):
        if sig not in self._loaded:
            path = os.path.join(self.bundle_dir, self._by_sig[sig]['file'])
            self._loaded[sig] = load_exported_program(path)
        return self._loaded[sig]

    def run(self, batch, rng=None):
        """``(staged, outputs)`` of the program for ``batch``'s signature;
        ``rng`` is accepted for the JAX signature (the port's predict step
        draws no noise)."""
        batch = numeric_features(batch)
        sig = _signature(batch)
        if sig not in self._by_sig:
            available = [(p['batch'], p['max_frames']) for p in self.manifest['programs']]
            raise ValueError(
                f'no exported program matches this batch '
                f'(batch={next(iter(batch.values())).shape[0]}, '
                f'max_frames={_max_frames(sig)}); bundle has '
                f'(batch, max_frames) = {available}. Collate to an exported '
                'shape or re-export with the shapes you serve.')
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        return self._program(sig)(self.params, batch, rng)


def main(argv=None):
    """The export command line (``export.py:168``); prints one JSON line."""
    parser = argparse.ArgumentParser(
        description='Export a self-contained deployment bundle: one torch.export predict '
                    'program per padded batch shape, plus the parameters and a manifest.')
    parser.add_argument('--model', required=True,
                        help="'module:Class' or 'path/to/file.py:Class'")
    parser.add_argument('--model_kwargs', default='{}')
    parser.add_argument('--checkpoint_path', required=True)
    parser.add_argument('--data_root', default='data')
    parser.add_argument('--data_dir', default='test',
                        help='Split whose batches define the exported shapes (the walk covers '
                             'every length bucket).')
    parser.add_argument('--id_list', default=None,
                        help='Id list path relative to --data_dir (default: '
                             '{data_dir}/{data_dir}_file_id_list.scp, as in serving).')
    parser.add_argument('--normalisation_dir', default='train')
    parser.add_argument('--out_dir', required=True)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                        help="Device to export FOR: the programs are specific to it.")
    parser.add_argument('--compute_dtype', default=None, type=precision.compute_dtype_arg,
                        help="'bfloat16': export programs with bf16 products (the bf16 kernels' "
                             'op nodes) and f32 sums.')
    parser.add_argument('--quantize', default=None, choices=('int8', 'int4'),
                        help='Bake weight-only quantization into the bundle (params.npz holds '
                             'the int8/int4 leaves).')
    args = parser.parse_args(argv)

    engine = InferenceEngine(
        load_model_class(args.model), args.checkpoint_path, data_root=args.data_root,
        normalisation_dir=args.normalisation_dir,
        model_kwargs=ast.literal_eval(args.model_kwargs), device=args.device,
        batch_size=args.batch_size, quantize=args.quantize, compute_dtype=args.compute_dtype)
    id_list = args.id_list or os.path.join(args.data_dir, f'{args.data_dir}_file_id_list.scp')
    manifest = export_bundle(engine, args.out_dir, data_dir=args.data_dir, id_list=id_list,
                             model_spec=args.model)
    print(json.dumps({
        'out_dir': args.out_dir,
        'programs': len(manifest['programs']),
        'shapes': [(p['batch'], p['max_frames']) for p in manifest['programs']],
        'quantized': bool(manifest['quantize']),
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
