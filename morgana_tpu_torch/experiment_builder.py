"""Experiment orchestration: CLI flags and the train/valid/test lifecycle
(counterpart of ``morgana_tpu/experiment_builder.py``).

Each batch is one :meth:`~morgana_tpu_torch.training.TrainLoop.train_step`
on the device: on the GPU every LSTM layer runs kernel K1 forward (writing
its gate trace) and kernel K2 backward, every GRU layer kernels K3 and K4.
Outputs keep the JAX package's layout under
``{experiments_base}/{experiment_name}``: ``config.json``,
``checkpoints/epoch_{N}.npz`` (which the JAX package loads) with its
``epoch_{N}.train.pkl`` sidecar (the optimiser chain, EMA, step and LR
schedule, from which either package's builder resumes), with
``--step_checkpoint_interval`` a rolling ``checkpoints/step.npz`` and its
sidecar (the batch position and the loader's length maps too),
``train/epoch_{N}/metrics.json`` (with ``epoch_duration_s``, ``ms_per_step``
and ``frames_per_sec``; with ``--log_norms`` the gradient, parameter and
update norms), ``valid/epoch_{N}/metrics.json``, ``metrics.pdf``, the
tensorboard scalars and ``log/``. Every ``--valid_output_interval`` epochs
the validation runs the model's analysis hooks (the acoustic models
synthesise ``valid/epoch_{N}/synth/*.wav``); ``--test`` predicts the test set
every ``--test_output_interval`` epochs, or once from ``--checkpoint_path``
without training, through the test hooks into ``test/epoch_{N}/``.

``--compute_dtype bfloat16`` trains in bf16 (``experiment_builder.py:337``,
:494): it sets the process's :func:`morgana_tpu_torch.nn.set_default_compute_dtype`,
so every dense product, attention and scan-backend recurrence reads its
operands rounded to bf16 and sums in f32, forward and backward (on the GPU
K1c with its gate trace and K2c, K3c and K4c, K5b and its backward, and the
bf16 weight-gradient carry); the parameters, the optimiser state, the EMA
and the checkpoints stay f32. The flags are the JAX package's but for
:data:`UNPORTED_FLAGS` (parallelism and the device-side fast path), each an
argparse error. ``--device`` defaults to ``cuda`` and raises
:class:`~morgana_tpu_torch.device.DeviceError` without a GPU; ``--device
cpu`` runs the kernels' plain versions on the CPU.
"""
import argparse
import ast
import contextlib
import json
import os
import re
import sys
import time

import numpy as np
import torch

from morgana_tpu_torch import _build
from morgana_tpu_torch import _logging
from morgana_tpu_torch import checkpointing
from morgana_tpu_torch import data
from morgana_tpu_torch import lr_schedules
from morgana_tpu_torch import memory
from morgana_tpu_torch import nn
from morgana_tpu_torch import utils
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.device import resolve_device
from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.training import TrainLoop, batch_items, build_optimizer
from morgana_tpu_torch.viz import plotting

__all__ = ['ExperimentBuilder', 'Callback', 'EarlyStopping', 'add_boolean_arg', 'DictAction',
           'UNPORTED_FLAGS']

#: The JAX builder's settings the port lacks, by ``dest``: their option
#: strings, their JAX default and where ROADMAP.md places them. Each option
#: is an argparse error, and so is a ``--config`` key of one whose value is
#: not the default.
UNPORTED_FLAGS = {
    'data_parallel': (('--data_parallel',), False, 'Queue 1 item 10'),
    'fsdp': (('--fsdp',), False, 'Queue 1 item 10'),
    'tensor_parallel': (('--tensor_parallel',), 1, 'Queue 1 item 10'),
    'shard_map_step': (('--shard_map_step',), False, 'Queue 1 item 10'),
    'multihost': (('--multihost',), False, 'Queue 1 item 10'),
    'orbax_dir': (('--orbax_dir',), None, 'Queue 1 item 10'),
    'device_cache': (('--device_cache', '--no-device_cache'), None, 'Queue 1 item 8'),
    'device_cache_gb': (('--device_cache_gb',), 4.0, 'Queue 1 item 8'),
    'device_normalise': (('--device_normalise', '--no-device_normalise'), None,
                         'Queue 1 item 8'),
    'steps_per_dispatch': (('--steps_per_dispatch',), None, 'Queue 1 item 8'),
    'remat': (('--remat',), False, 'Queue 1 item 8'),
    'transfer_dtype': (('--transfer_dtype',), None, 'Queue 1 item 5'),
}
_UNPORTED_OPTIONS = {option: (dest, where) for dest, (options, _, where) in UNPORTED_FLAGS.items()
                     for option in options}


#: Seconds of device idle at each end of a --profile_dir trace.
PROFILE_MARGIN_S = 0.02


def add_boolean_arg(parser, name, help):
    r"""Adds paired ``--x`` / ``--no-x`` boolean flags, ``--x`` the default."""
    parser.add_argument(f'--{name}', dest=name, action='store_true', default=True, help=help)
    parser.add_argument(f'--no-{name}', dest=name, action='store_false', help=argparse.SUPPRESS)


class DictAction(argparse.Action):
    r"""Parses a Python dict literal with ``ast.literal_eval``."""

    def __init__(self, option_strings, dest, nargs=None, **kwargs):
        if nargs is not None:
            raise ValueError('nargs not allowed')
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, ast.literal_eval(values))


class Callback:
    r"""Hooks into the training routine (``experiment_builder.py:63``): pass
    instances as ``ExperimentBuilder(..., callbacks=[...])`` and override any
    of them; each receives the builder. ``on_epoch_end`` and
    ``on_valid_end`` may return True to stop after the current epoch, its
    checkpoint saved."""

    def on_train_begin(self, builder):
        pass

    def on_epoch_begin(self, builder, epoch):
        pass

    def on_epoch_end(self, builder, epoch, train_loss):
        pass

    def on_valid_end(self, builder, epoch, valid_loss):
        pass

    def on_train_end(self, builder):
        pass


class EarlyStopping(Callback):
    r"""Stops training once the validation loss has not improved by more
    than ``min_delta`` for ``patience`` epochs (``experiment_builder.py:87``).
    Needs ``valid=True``."""

    def __init__(self, patience=5, min_delta=0.0):
        self.patience = int(patience)
        self.min_delta = float(min_delta)
        self.best = float('inf')
        self.stale = 0

    def on_valid_end(self, builder, epoch, valid_loss):
        if valid_loss < self.best - self.min_delta:
            self.best = float(valid_loss)
            self.stale = 0
            return False
        self.stale += 1
        if self.stale >= self.patience:
            builder.logger.info('epoch %2d: early stopping — valid loss has not improved for '
                                '%d epochs (best %.4f)', epoch, self.stale, self.best)
            return True
        return False


class _NaNWatch(object):
    """``--debug_nans``: forward hooks on every module of a model that raise
    ``FloatingPointError`` at the first module whose output is not finite,
    naming it and the step (``step()`` gives the step)."""

    def __init__(self, model, step):
        self._step = step
        for name, module in model.named_modules():
            module.register_forward_hook(self._hook(name or type(model).__name__))

    def _hook(self, name):
        def check(module, inputs, output):
            for tensor in _tensors(output):
                if tensor.is_floating_point() and not bool(torch.isfinite(tensor).all()):
                    raise FloatingPointError(
                        f'debug_nans: module {name} ({type(module).__name__}) gave a non-finite '
                        f'output in the forward pass of step {self._step()}')
        return check


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


class ExperimentBuilder(object):
    r"""Runs training, validation and generation of one model
    (``experiment_builder.py:112``).

    Parameters
    ----------
    model_class : morgana_tpu_torch.base_models.BaseModel subclass
    experiment_name : str
        Output directory name under ``experiments_base``.
    callbacks : list of Callback, optional
    kwargs
        Flag values by their ``dest`` names (:meth:`add_args`); a missing one
        takes its flag's default, an unknown one raises ``TypeError``.
    """

    @classmethod
    def add_args(cls, parser):
        r"""Adds the command line arguments (``experiment_builder.py:164``)."""
        parser.add_argument('--model_kwargs', dest='model_kwargs', action=DictAction, type=str,
                            default={}, help='Keyword arguments of the model constructor, a '
                                             'quoted Python dict literal.')
        parser.add_argument('--analysis_kwargs', dest='analysis_kwargs', action=DictAction,
                            type=str, default={'sample_rate': 16000},
                            help='Keyword arguments of the analysis hooks (e.g. the synthesis '
                                 'sample rate), a quoted Python dict literal.')

        add_boolean_arg(parser, 'train', help='Run the training loop over --train_id_list '
                                              '(from --start_epoch to --end_epoch).')
        add_boolean_arg(parser, 'valid', help='Evaluate on --valid_id_list after every '
                                              'training epoch.')
        parser.add_argument('--test', dest='test', action='store_true', default=False,
                            help='Run generation (predict without a loss, then the test '
                                 'analysis hooks) over --test_id_list: every '
                                 '--test_output_interval epochs when training, else once from '
                                 '--checkpoint_path.')

        parser.add_argument('--start_epoch', dest='start_epoch', type=int, default=1,
                            help='First epoch number of this run.')
        parser.add_argument('--end_epoch', dest='end_epoch', type=int, default=50,
                            help='Last epoch number (inclusive) of this run.')
        parser.add_argument('--checkpoint_path', dest='checkpoint_path', type=str, default=None,
                            help='Initialise the parameters from this epoch_{N}.npz (written '
                                 'by either package); when training, the optimiser, EMA, '
                                 'step and LR-schedule state too, from the '
                                 'epoch_{N}.train.pkl beside it. \'latest\' resumes the newest '
                                 'checkpoint of this experiment (a newer rolling step '
                                 'checkpoint at its batch), or starts afresh when there is '
                                 'none.')
        parser.add_argument('--ema_checkpoint_path', dest='ema_checkpoint_path', type=str,
                            default=None, help='Initialise the EMA parameters from this '
                                               "checkpoint ('latest': the newest "
                                               'epoch_{N}_ema.npz); default --checkpoint_path.')

        parser.add_argument('--batch_size', dest='batch_size', type=int, default=32,
                            help='Utterances per training/validation batch.')
        parser.add_argument('--learning_rate', dest='learning_rate', type=float, default=0.01,
                            help='Base learning rate (the value LR schedules scale).')
        parser.add_argument('--lr_schedule_name', dest='lr_schedule_name', type=str,
                            default='constant', help='Learning-rate schedule '
                                                     '(morgana_tpu_torch.lr_schedules.SUPPORTED).')
        parser.add_argument('--lr_schedule_kwargs', dest='lr_schedule_kwargs', action=DictAction,
                            type=str, default={}, help='Schedule settings, a quoted dict literal.')
        parser.add_argument('--weight_decay', dest='weight_decay', type=float, default=0.,
                            help='L2 regularisation (0 disables it): added to the gradient for '
                                 'adam and sgd, decoupled for adamw and lamb.')
        parser.add_argument('--optimizer', dest='optimizer', type=str, default='adam',
                            help='adam (torch-Adam semantics), adamw (decoupled weight decay), '
                                 'sgd or lamb (AdamW scaled by the per-parameter trust ratio).')
        parser.add_argument('--optimizer_kwargs', dest='optimizer_kwargs', action=DictAction,
                            type=str, default={}, help='Optimiser settings (b1, b2, eps for the '
                                                       'Adam family; momentum, nesterov for '
                                                       'sgd), a quoted dict literal.')
        parser.add_argument('--ema_decay', dest='ema_decay', type=float, default=0.,
                            help='Decay of an exponential moving average of the parameters; '
                                 'when non-zero, validation uses the average.')

        parser.add_argument('--device', dest='device', type=str, default='cuda',
                            help="'cuda' (the default; an error without a GPU), 'cuda:N' or "
                                 "'cpu'.")
        parser.add_argument('--num_data_threads', dest='num_data_threads', type=int, default=0,
                            help="Threads that read each batch's utterances (0 reads them "
                                 'inline).')

        parser.add_argument('--model_checkpoint_interval', dest='model_checkpoint_interval',
                            type=int, default=1, help='Save a checkpoint every N epochs.')
        parser.add_argument('--step_checkpoint_interval', dest='step_checkpoint_interval',
                            type=int, default=0,
                            help='If > 0, save a rolling mid-epoch checkpoint '
                                 '(checkpoints/step.npz and its sidecar) every N train batches, '
                                 'at applied updates; --checkpoint_path latest resumes it at the '
                                 'exact batch (with --length_sort_window too: the loader\'s '
                                 'length maps ride in the sidecar).')
        parser.add_argument('--train_output_interval', dest='train_output_interval', type=int,
                            default=10, help='Run the train-set analysis hooks every N epochs.')
        parser.add_argument('--valid_output_interval', dest='valid_output_interval', type=int,
                            default=10, help='Run the validation-set analysis hooks every N '
                                             'epochs.')
        parser.add_argument('--test_output_interval', dest='test_output_interval', type=int,
                            default=10, help='Run the test-set analysis hooks every N epochs.')

        parser.add_argument('--data_root', dest='data_root', type=str, default='data',
                            help='Directory under which every corpus sub-directory lives.')
        parser.add_argument('--train_dir', dest='train_dir', type=str, default='train',
                            help='Training-corpus sub-directory of --data_root.')
        parser.add_argument('--valid_dir', dest='valid_dir', type=str, default='valid',
                            help='Validation-corpus sub-directory of --data_root.')
        parser.add_argument('--test_dir', dest='test_dir', type=str, default='test',
                            help='Test-corpus sub-directory of --data_root.')
        parser.add_argument('--train_id_list', dest='train_id_list', type=str,
                            default='train_file_id_list.scp',
                            help='Utterance-id list of the training set, under --data_root.')
        parser.add_argument('--valid_id_list', dest='valid_id_list', type=str,
                            default='valid_file_id_list.scp',
                            help='Utterance-id list of the validation set, under --data_root.')
        parser.add_argument('--test_id_list', dest='test_id_list', type=str,
                            default='test_file_id_list.scp',
                            help='Utterance-id list of the test set, under --data_root.')
        parser.add_argument('--normalisation_dir', dest='normalisation_dir', type=str,
                            default='train', help='Sub-directory of --data_root with the '
                                                  'normaliser parameter JSON files.')
        parser.add_argument('--experiments_base', dest='experiments_base', type=str,
                            default='experiments', help='Directory of all experiment outputs.')
        parser.add_argument('--experiment_name', dest='experiment_name', type=str,
                            required=True, help="This run's directory under --experiments_base.")

        parser.add_argument('--seed', dest='seed', type=int, default=1234567890,
                            help='Seed of the parameter init, the shuffle and dropout.')
        parser.add_argument('--keep_checkpoints', dest='keep_checkpoints', type=int, default=0,
                            help='If > 0, keep only the newest N epochs\' checkpoints (and their '
                                 'EMA and sidecar files); emergency checkpoints are kept.')
        parser.add_argument('--compilation_cache_dir', dest='compilation_cache_dir', type=str,
                            default=None, help='Build and find the CUDA kernels in this '
                                               'directory: a new process that finds them there '
                                               'runs no compiler.')
        parser.add_argument('--log_interval', dest='log_interval', type=int, default=1,
                            help='Batches between progress-bar metric prints; each print reads '
                                 'the device (a host sync), none happens between them.')
        parser.add_argument('--profile_dir', dest='profile_dir', type=str, default=None,
                            help='If set, write a torch.profiler trace (with CUDA activity) of '
                                 'the first training epoch there.')
        parser.add_argument('--grad_clip_norm', dest='grad_clip_norm', type=float, default=0.,
                            help='If > 0, clip the global gradient norm before the optimiser.')
        parser.add_argument('--grad_accum_steps', dest='grad_accum_steps', type=int, default=1,
                            help='If > 1, sum the item-weighted gradients of N batches and apply '
                                 'the optimiser and EMA once a cycle (the epoch\'s last batch '
                                 'closes a short one); batch-level LR schedules step once an '
                                 'applied update.')
        parser.add_argument('--length_sort_window', dest='length_sort_window', type=int,
                            default=0, help='If > 0, sort utterances by length within windows '
                                            'of N batches (after a first shuffled epoch).')
        parser.add_argument('--compute_dtype', dest='compute_dtype',
                            type=precision.compute_dtype_arg, default='float32',
                            help="Product compute dtype: 'float32' (default) or 'bfloat16' "
                                 '(bf16 operands with f32 sums, state, parameters and '
                                 'optimiser); another dtype is an error.')
        parser.add_argument('--debug_nans', dest='debug_nans', action='store_true',
                            default=False,
                            help='Diagnosis: raise FloatingPointError at the first module whose '
                                 'output is not finite, forward (module hooks) or backward '
                                 '(autograd anomaly mode), naming it and the step. Syncs at '
                                 'every module: slow.')
        parser.add_argument('--log_norms', dest='log_norms', action='store_true', default=False,
                            help='Log grad_norm (raw, before clipping), param_norm and '
                                 'update_norm (lr times the update) of every applied update as '
                                 'train metrics (metrics.json, tensorboard); no host sync.')
        parser.add_argument('--memory_report', dest='memory_report', action='store_true',
                            default=False,
                            help="Write memory_report.txt after the first training step: the "
                                 'parameter, optimiser-state and gradient bytes, the step\'s '
                                 'measured peak and the allocator\'s counters.')
        parser.add_argument('--find_lr', dest='find_lr', type=str, default=None,
                            help="LR range test instead of training: 'MIN,MAX[,STEPS]' sweeps "
                                 'the learning rate exponentially over real train steps (each '
                                 'micro-batch under --grad_accum_steps), stops when the smoothed '
                                 'loss passes 4x its best, writes lr_find.json (and lr_find.png '
                                 'with matplotlib) with a steepest-descent suggestion, and '
                                 'exits.')
        parser.add_argument('--search_batch_size', dest='search_batch_size', type=float,
                            default=0., help='If > 0: instead of training, search the largest '
                                             'batch whose measured train-step peak fits this '
                                             'many GiB of device memory (at the first batch\'s '
                                             'length), write batch_size_search.txt and exit.')

    @classmethod
    def _parser(cls):
        parser = argparse.ArgumentParser(
            description='Experiment builder for the PyTorch/CUDA port of morgana_tpu.')
        cls.add_args(parser)
        return parser

    @classmethod
    def get_experiment_args(cls, argv=None):
        r"""Parses the command line (``argv``, default ``sys.argv[1:]``) into
        the args dict (``experiment_builder.py:125-162``). ``--config PATH``
        takes defaults from a JSON file (a run's ``config.json``, of either
        package); flags on the command line override them. Keys the port
        does not know are printed and ignored, except one of
        :data:`UNPORTED_FLAGS` whose value is not the JAX default: that is
        the same argparse error as the flag."""
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument('--config', dest='config', type=str, default=None)
        pre_args, _ = pre.parse_known_args(argv)

        parser = cls._parser()
        parser.add_argument('--config', dest='config', type=str, default=None,
                            help="JSON file of argument values (e.g. a previous run's "
                                 'config.json); command-line flags override it.')
        if pre_args.config:
            with open(pre_args.config) as f:
                config = json.load(f)
            known = {action.dest for action in parser._actions}
            for key in sorted(set(config) & set(UNPORTED_FLAGS)):
                options, default, where = UNPORTED_FLAGS[key]
                if config[key] != default:
                    parser.error(f'{options[0]} is not ported yet (ROADMAP.md, {where}): '
                                 f'--config {pre_args.config} sets {key}={config[key]!r}')
            unknown = sorted(set(config) - known)
            if unknown:
                print(f'--config: ignoring unknown keys {unknown}', file=sys.stderr)
            parser.set_defaults(**{k: v for k, v in config.items()
                                   if k in known and k != 'config'})

        args, extra = parser.parse_known_args(argv)
        for option in extra:
            name = option.split('=')[0]
            if name in _UNPORTED_OPTIONS:
                parser.error(f'{name} is not ported yet (ROADMAP.md, '
                             f'{_UNPORTED_OPTIONS[name][1]})')
        if extra:
            parser.error(f'unrecognized arguments: {" ".join(extra)}')
        args = vars(args)
        args.pop('config', None)
        return args

    def __init__(self, model_class, experiment_name, callbacks=None, **kwargs):
        settings = vars(self._parser().parse_args(['--experiment_name', experiment_name]))
        unknown = sorted(set(kwargs) - set(settings))
        if unknown:
            raise TypeError(f'ExperimentBuilder got settings the port does not have: {unknown}')
        settings.update(kwargs)
        self.settings = settings
        self.model_class = model_class
        self.experiment_name = experiment_name
        self.callbacks = list(callbacks or [])
        self.model_kwargs = settings['model_kwargs']
        self.analysis_kwargs = settings['analysis_kwargs']
        for name in ('train', 'valid', 'test', 'start_epoch', 'end_epoch', 'checkpoint_path',
                     'ema_checkpoint_path', 'batch_size', 'learning_rate', 'lr_schedule_name',
                     'lr_schedule_kwargs', 'weight_decay', 'ema_decay', 'seed',
                     'num_data_threads', 'model_checkpoint_interval', 'train_output_interval',
                     'valid_output_interval', 'test_output_interval', 'data_root', 'train_dir',
                     'valid_dir', 'test_dir', 'train_id_list', 'valid_id_list', 'test_id_list',
                     'normalisation_dir', 'experiments_base', 'keep_checkpoints',
                     'log_interval', 'profile_dir', 'length_sort_window', 'memory_report',
                     'find_lr'):
            setattr(self, name, settings[name])
        self.step_checkpoint_interval = int(settings['step_checkpoint_interval'] or 0)
        self.search_batch_size = float(settings['search_batch_size'] or 0.)
        # Mid-epoch resume: the batches of the first epoch already in the
        # restored parameters, and the loader's length maps then.
        self._resume_batches_done = 0
        self._resume_loader_lengths = None
        self._train_state_cache = {}
        self._memory_report_written = False
        self._profiler = None

        if settings['compilation_cache_dir']:
            _build.set_build_dir(settings['compilation_cache_dir'])
        self.device = resolve_device(settings['device'])
        self.compute_dtype = settings['compute_dtype']
        # A process global, read at each call, as the JAX builder sets it.
        nn.set_default_compute_dtype(self.compute_dtype)

        self.experiment_dir = os.path.join(self.experiments_base, self.experiment_name)
        self.logger = _logging.create_logger(self.experiment_dir)
        self._lr_schedule = lr_schedules.init_lr_schedule(self.lr_schedule_name,
                                                          **self.lr_schedule_kwargs)
        self.resolve_latest_checkpoints()
        if self.ema_checkpoint_path is None:
            self.ema_checkpoint_path = self.checkpoint_path
        self.epoch = 0
        self.resolve_setting_conflicts()
        # Per-batch train losses of each epoch, fetched once at its end.
        self.train_losses = {}

        torch.manual_seed(self.seed)
        self.model = self.build_model(self.model_class, self.model_kwargs, self.checkpoint_path)
        normalisers = data.Normalisers(self.model.normaliser_sources(), self.normalisation_dir,
                                       self.data_root)
        self.model.normalisers = normalisers

        ema_model = None
        if self.ema_decay:
            ema_model = self.build_model(self.model_class, self.model_kwargs,
                                         self.ema_checkpoint_path)
            ema_model.normalisers = normalisers
            ema_model.metrics = self.model.metrics  # one handler collects every metric
        optimizer = build_optimizer(settings['optimizer'], weight_decay=self.weight_decay,
                                    grad_clip_norm=settings['grad_clip_norm'],
                                    **settings['optimizer_kwargs'])
        self.loop = TrainLoop(self.model, optimizer, ema_decay=self.ema_decay, seed=self.seed,
                              ema_model=ema_model, grad_accum_steps=settings['grad_accum_steps'],
                              log_norms=settings['log_norms'])
        self._restored_lr_state = None
        if self.checkpoint_path and self.train:
            self.restore_training_state(self.checkpoint_path)
        self._nan_watch = (_NaNWatch(self.model, lambda: self.model.step)
                           if settings['debug_nans'] else None)
        self.logger.info('Running on %s (%s)', self.device,
                         torch.cuda.get_device_name(self.device)
                         if self.device.type == 'cuda' else 'plain versions of the kernels')

        if self.train:
            self.train_loader = self.load_data(self.model.train_data_sources(), self.train_dir,
                                               self.train_id_list, normalisers, name='train')
        if self.valid:
            self.valid_loader = self.load_data(self.model.valid_data_sources(), self.valid_dir,
                                               self.valid_id_list, normalisers, name='valid',
                                               shuffle=False)
        if self.test:
            self.test_loader = self.load_data(self.model.test_data_sources(), self.test_dir,
                                              self.test_id_list, normalisers, name='test',
                                              shuffle=False)
        self.log_initial_setup()
        self.model.tensorboard = self._tensorboard()
        self.model.finalise_init()
        if ema_model is not None:
            ema_model.finalise_init()

    def log_initial_setup(self):
        r"""Writes ``config.json`` (every setting) and ``model_summary.txt``;
        the settings also go to the log file."""
        os.makedirs(self.experiment_dir, exist_ok=True)
        with open(os.path.join(self.experiment_dir, 'model_summary.txt'), 'w') as f:
            f.write(str(self.model))
        self.logger.debug('settings: %s', json.dumps(self.settings, default=str))
        with open(os.path.join(self.experiment_dir, 'config.json'), 'w') as f:
            json.dump(self.settings, f, indent=4, default=str)

    def _tensorboard(self):
        """A ``torch.utils.tensorboard`` writer on the experiment directory,
        or None with a warning when the ``tensorboard`` package is missing
        (``experiment_builder.py:867-870``)."""
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as exc:
            self.logger.warning('tensorboard unavailable (%s); model.tensorboard is None', exc)
            return None
        return SummaryWriter(self.experiment_dir)

    def resolve_setting_conflicts(self):
        r"""Checks the settings (``experiment_builder.py:1194``)."""
        if not (self.train or self.valid or self.test):
            raise ValueError('No process specified, use --train, --valid or --test.')
        if self.train:
            if self.checkpoint_path:
                checkpoint_epoch = utils.get_epoch_from_checkpoint_path(self.checkpoint_path)
                if self.start_epoch <= checkpoint_epoch:
                    raise ValueError(
                        f'--start_epoch {self.start_epoch} is not after the epoch of '
                        f'--checkpoint_path {self.checkpoint_path} ({checkpoint_epoch}): later '
                        'checkpoints would overwrite it. Increase --start_epoch.')
            if self.lr_schedule_name == 'plateau' and not self.valid:
                raise ValueError("The 'plateau' learning rate schedule needs --valid.")
        else:
            if not self.checkpoint_path:
                raise ValueError('Validation or testing without training needs '
                                 '--checkpoint_path.')
            self.epoch = utils.get_epoch_from_checkpoint_path(self.checkpoint_path)

    def build_model(self, model_class, model_kwargs, checkpoint_path=None):
        r"""The model on the builder's device, with the checkpoint's parameters
        if one is given (``experiment_builder.py:1225``)."""
        model = model_class(**model_kwargs)
        if checkpoint_path:
            self.logger.info('Loading model checkpoint from %s', checkpoint_path)
            model.load_parameters(checkpoint_path)
        return model.to(self.device)

    # ----------------------------------------------------------- checkpoints

    def _checkpoint_dir(self):
        return os.path.join(self.experiment_dir, 'checkpoints')

    def _step_checkpoint_path(self):
        return os.path.join(self._checkpoint_dir(), 'step.npz')

    def _training_state_for(self, checkpoint_path):
        """The sidecar of a checkpoint, read once, or None when it is absent
        or unreadable (``experiment_builder.py:907``)."""
        path = checkpointing.training_state_path_for(checkpoint_path)
        if path not in self._train_state_cache:
            state = None
            if os.path.exists(path):
                try:
                    state = checkpointing.load_training_state(path)
                except Exception as exc:  # noqa: BLE001 - resume falls back, with a warning
                    self.logger.warning('Could not read training-state sidecar %s (%s)',
                                        path, exc)
            self._train_state_cache[path] = state
        return self._train_state_cache[path]

    def _mid_epoch_position(self, checkpoint_path):
        """``(epoch, batches_done, num_batches)`` of a checkpoint saved
        mid-epoch, from its sidecar, else None (``experiment_builder.py:922``)."""
        extra = (self._training_state_for(checkpoint_path) or {}).get('extra') or {}
        if extra.get('batches_done') is None or not extra.get('epoch'):
            return None
        return (int(extra['epoch']), int(extra['batches_done']),
                int(extra['num_batches']) if extra.get('num_batches') else None)

    def _save_step_checkpoint(self, batches_done, num_batches, lr_schedule):
        """The rolling mid-epoch checkpoint (``experiment_builder.py:976``):
        ``checkpoints/step.npz`` and its sidecar, each written atomically,
        the sidecar with the batch position and (with
        ``--length_sort_window``) the loader's length maps."""
        path = checkpointing.save_state_dict(nn.state_dict(self.model),
                                             self._step_checkpoint_path())
        sidecar = checkpointing.training_state_path_for(path)
        checkpointing.save_training_state(
            sidecar, **self.loop.jax_state(),
            extra={'lr_schedule': lr_schedule.state_dict(), 'epoch': int(self.epoch),
                   'batches_done': int(batches_done), 'num_batches': int(num_batches),
                   'loader_lengths': (self.train_loader.lengths_state()
                                      if self.length_sort_window else None)})
        self._train_state_cache.pop(sidecar, None)

    def _latest_checkpoint(self, ema=False):
        """The newest ``epoch_{N}.npz`` (``epoch_{N}_ema.npz``) of this
        experiment, or None; emergency checkpoints are not considered."""
        ckpt_dir = self._checkpoint_dir()
        if not os.path.isdir(ckpt_dir):
            return None
        pattern = re.compile(r'epoch_(\d+)_ema\.npz' if ema else r'epoch_(\d+)\.npz')
        found = [(int(m.group(1)), f) for f in os.listdir(ckpt_dir)
                 for m in [pattern.fullmatch(f)] if m]
        return os.path.join(ckpt_dir, max(found)[1]) if found else None

    def resolve_latest_checkpoints(self):
        r"""``--checkpoint_path latest`` (``experiment_builder.py:1038``): the
        newest epoch checkpoint of the experiment (a fresh start when there
        is none), ``start_epoch`` moved past it, or a newer rolling step
        checkpoint at its batch. ``--ema_checkpoint_path latest``: the newest
        ``_ema`` checkpoint."""
        if self.checkpoint_path != 'latest' and self.ema_checkpoint_path != 'latest':
            return
        resolved_main = self.checkpoint_path == 'latest'
        if resolved_main:
            self.checkpoint_path = self._latest_checkpoint()
            self.logger.info('Resolved --checkpoint_path latest -> %s',
                             self.checkpoint_path or '(none; fresh start)')
        if self.ema_checkpoint_path == 'latest':
            self.ema_checkpoint_path = self._latest_checkpoint(ema=True)
        if resolved_main and self.checkpoint_path and self.train:
            ckpt_epoch = utils.get_epoch_from_checkpoint_path(self.checkpoint_path)
            if self.start_epoch <= ckpt_epoch:
                self.start_epoch = ckpt_epoch + 1
                self.logger.info('Resuming: start_epoch -> %d', self.start_epoch)
        if resolved_main and self.train:
            self._maybe_resolve_step_checkpoint()

    def _maybe_resolve_step_checkpoint(self):
        """A rolling ``step.npz`` newer than the newest epoch checkpoint
        (its sidecar names a later epoch) is where ``latest`` resumes, at its
        batch; an older one is stale and ignored, and so is one whose sidecar
        cannot be read (``experiment_builder.py:1063``)."""
        step_ckpt = self._step_checkpoint_path()
        if not os.path.exists(step_ckpt):
            return
        position = self._mid_epoch_position(step_ckpt)
        if position is None:
            return
        step_epoch, batches_done, num_batches = position
        epoch_ckpt_epoch = (utils.get_epoch_from_checkpoint_path(self.checkpoint_path)
                            if self.checkpoint_path else 0)
        if step_epoch <= epoch_ckpt_epoch or self.start_epoch > step_epoch + 1:
            return
        self.checkpoint_path = step_ckpt
        if num_batches is not None and batches_done >= num_batches:
            self.start_epoch = step_epoch + 1
        else:
            self.start_epoch = step_epoch
        self.logger.info('Resolved --checkpoint_path latest -> %s (mid-epoch: epoch %d, %d/%s '
                         'batches done)', step_ckpt, step_epoch, batches_done,
                         num_batches if num_batches is not None else '?')

    def _prune_checkpoints(self, keep):
        """Deletes all but the newest ``keep`` epochs' checkpoint files
        (parameters, EMA, sidecars); emergency ``_interrupted`` saves stay
        (``experiment_builder.py:1093``)."""
        ckpt_dir = self._checkpoint_dir()
        if not os.path.isdir(ckpt_dir):
            return
        by_epoch = {}
        for fname in os.listdir(ckpt_dir):
            if '_interrupted' in fname:
                continue
            match = re.match(r'epoch_(\d+)', fname)
            if match:
                by_epoch.setdefault(int(match.group(1)), []).append(fname)
        for epoch in sorted(by_epoch)[:-keep]:
            for fname in by_epoch[epoch]:
                try:
                    os.remove(os.path.join(ckpt_dir, fname))
                except OSError:
                    pass

    def restore_training_state(self, checkpoint_path):
        r"""Exact resume (``experiment_builder.py:756-828``): when a
        ``.train.pkl`` sidecar of either package sits beside
        ``checkpoint_path``, the optimiser state, the EMA parameters and the
        step count are taken from it, and the LR-schedule state at
        :meth:`run_train`. For the rolling step checkpoint the sidecar's
        parameters win over ``step.npz`` (a torn pair of the two), and its
        batch position and length maps place the first epoch. Without a
        sidecar the optimiser starts afresh, as in the JAX package."""
        state = self._training_state_for(checkpoint_path)
        if state is None:
            return
        extra = state.get('extra') or {}
        self._restored_lr_state = extra.get('lr_schedule')
        if state.get('params') is not None and os.path.normpath(checkpoint_path) == \
                os.path.normpath(self._step_checkpoint_path()):
            nn.load_jax_params(self.model, state['params'])
        self.loop.restore_jax_state(state)
        self.logger.info('Restored optimiser state from %s (step %d)',
                         checkpointing.training_state_path_for(checkpoint_path),
                         self.loop.step_count)
        position = self._mid_epoch_position(checkpoint_path)
        if position is None:
            return
        step_epoch, batches_done, num_batches = position
        if step_epoch == self.start_epoch and (num_batches is None or batches_done < num_batches):
            self._resume_batches_done = batches_done
            self.logger.info('Mid-epoch resume: epoch %d restarts at batch %d', step_epoch,
                             batches_done + 1)
            self._resume_loader_lengths = extra.get('loader_lengths')
            if self.length_sort_window and self._resume_loader_lengths is None:
                self.logger.warning(
                    'Mid-epoch resume with --length_sort_window %s: the sidecar has no length '
                    'maps, so epoch %d is approximately (not exactly) resumed.',
                    self.length_sort_window, step_epoch)

    def load_data(self, data_sources, data_dir, id_list, normalisers=None, name='', shuffle=True):
        r"""The dataset and batching loader of one split (``experiment_builder.py:1233``)."""
        self.logger.info('Loading %s data using %s from %s/%s',
                         name, id_list, self.data_root, data_dir)
        dataset = data.FilesDataset(data_sources, data_dir, id_list, normalisers, self.data_root)
        return data.DataLoader(dataset, batch_size=self.batch_size, shuffle=shuffle,
                               num_data_threads=self.num_data_threads, seed=self.seed,
                               length_sort_window=self.length_sort_window if shuffle else 0)

    # ----------------------------------------------------------------- train

    def _log_metrics_to_tensorboard(self, mode):
        """The epoch's visible scalar metrics to tensorboard
        (``experiment_builder.py:1322``)."""
        tb = self.model.tensorboard
        if tb is None:
            return
        for name, value in self.model.metrics.results_as_json_dict(mode).items():
            if isinstance(value, (int, float)):
                tb.add_scalar(f'{mode}/{name}', value, self.epoch)
        tb.flush()

    def train_epoch(self, data_loader, lr_schedule=None, gen_output=False, out_dir=None):
        r"""Trains once over all batches (after a mid-epoch resume, the
        remaining ones); writes the epoch's ``metrics.json`` with its timing.
        Returns the mean batch loss (``experiment_builder.py:1345``)."""
        self.model.mode = 'train'
        self.model.metrics.reset_state('train')
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

        num_batches = len(data_loader)
        skip = 0
        if self._resume_batches_done:
            skip, self._resume_batches_done = self._resume_batches_done, 0
            if self._resume_loader_lengths is not None:
                data_loader.set_lengths(self._resume_loader_lengths)
                self._resume_loader_lengths = None
            data_loader.set_skip_batches(skip)
        epoch_start = time.perf_counter()
        losses, frames = self._train_batches(data_loader, lr_schedule, gen_output, out_dir,
                                             skip, num_batches)
        if gen_output:
            self.model.analysis_for_train_epoch(out_dir=out_dir, **self.analysis_kwargs)

        # One host transfer for the epoch's losses, which also waits for the
        # device to finish the epoch before the clock is read.
        batch_losses = [] if not losses else \
            torch.stack(losses).double().cpu().numpy().tolist()
        duration = time.perf_counter() - epoch_start
        self.train_losses[self.epoch] = batch_losses
        if out_dir:
            epoch_metrics = dict(self.model.metrics.results_as_json_dict('train'))
            epoch_metrics['epoch_duration_s'] = round(duration, 3)
            if num_batches - skip:
                epoch_metrics['ms_per_step'] = round(1e3 * duration / (num_batches - skip), 3)
            if frames:
                epoch_metrics['frames_per_sec'] = round(frames / duration, 1)
            file_io.save_json(epoch_metrics, os.path.join(out_dir, 'metrics.json'))
        self._log_metrics_to_tensorboard('train')
        self.model.mode = ''
        return float(np.mean(batch_losses)) if batch_losses else 0.0

    def _step_scope(self):
        """The scope of one train step: a profiler range while a trace is
        taken, anomaly mode under ``--debug_nans``."""
        scope = contextlib.ExitStack()
        if self._profiler is not None:
            scope.enter_context(torch.profiler.record_function(f'train step {self.model.step}'))
        if self._nan_watch is not None:
            scope.enter_context(torch.autograd.detect_anomaly(check_nan=True))
        return scope

    def _train_batches(self, data_loader, lr_schedule, gen_output, out_dir, skip, num_batches):
        """One train step per batch (``experiment_builder.py:1426``). Returns
        the per-batch device losses and the number of frames trained on."""
        losses = []
        frames = 0.
        pbar = _logging.ProgressBar(num_batches - skip, print_interval=self.log_interval)
        for i, features in zip(pbar, data_loader):
            self.model.step = (self.epoch - 1) * num_batches + skip + i + 1
            if 'n_frames' in features:
                frames += float(np.sum(features['n_frames']))
            lr = lr_schedule.lr if lr_schedule is not None else self.learning_rate
            report = self.memory_report and not self._memory_report_written
            if report and self.device.type == 'cuda':
                torch.cuda.reset_peak_memory_stats(self.device)
            try:
                with self._step_scope():
                    # The last batch closes an open accumulation cycle: every
                    # epoch ends on applied parameters.
                    batch_loss, output_features = self.loop.train_step(
                        features, lr, force_apply=skip + i == num_batches - 1)
            except RuntimeError as exc:
                if self._nan_watch is None:
                    raise
                raise FloatingPointError(f'debug_nans: the backward pass of step '
                                         f'{self.model.step} gave a non-finite value: {exc}') \
                    from exc
            if lr_schedule is not None and self.loop.last_step_applied and \
                    self.lr_schedule_name in lr_schedules.BATCH_LR_SCHEDULES:
                lr_schedule.step()
            losses.append(batch_loss)
            if report:
                self._write_memory_report(features)
            self.model.metrics.accumulate(self.model.mode, loss=batch_loss)
            pbar.maybe_print('train', self.epoch, lambda: dict(
                batch_loss=utils.format_float_tensor(batch_loss),
                **self.model.metrics.results_as_str_dict('train')))
            # The rolling checkpoint, at applied updates only: one inside an
            # open accumulation cycle could not resume exactly.
            if (self.step_checkpoint_interval and self.loop.last_step_applied
                    and (skip + i + 1) % self.step_checkpoint_interval == 0):
                self._save_step_checkpoint(skip + i + 1, num_batches, lr_schedule)
            if gen_output:
                self.model.analysis_for_train_batch(features, output_features, out_dir=out_dir,
                                                    **self.analysis_kwargs)
        return losses, frames

    def _write_memory_report(self, features):
        """``memory_report.txt`` after the first train step
        (``experiment_builder.py:1612``): the loop's state bytes, the step's
        measured peak above them (on the GPU) and the allocator's counters."""
        self._memory_report_written = True
        program = {f'{k}_bytes': v for k, v in memory.state_bytes(self.loop).items()}
        if self.device.type == 'cuda':
            peak = torch.cuda.max_memory_allocated(self.device)
            program['peak_bytes'] = int(peak)
            program['step_peak_above_state_bytes'] = int(peak) - sum(
                v for k, v in program.items() if k != 'peak_bytes')
        path = os.path.join(self.experiment_dir, 'memory_report.txt')
        with open(path, 'w') as f:
            f.write(memory.format_report(
                program, memory.device_memory_stats(self.device),
                batch_shapes={k: v.shape for k, v in memory.batch_shapes_at(
                    features, batch_items(features)).items()},
                header=f'{type(self.model).__name__} train step'))
        if 'peak_bytes' in program:
            self.logger.info('Train-step peak device memory %.2f MiB (report: %s)',
                             program['peak_bytes'] / 2 ** 20, path)
        else:
            self.logger.info('Memory report written to %s (no allocator peak on %s)', path,
                             self.device)

    def run_train(self):
        r"""Trains from ``start_epoch`` to ``end_epoch`` (``experiment_builder.py:1628``),
        with a profiler trace of the first epoch under ``--profile_dir``."""
        self.logger.info('epoch %2d: Beginning training', self.start_epoch)
        lr_schedule = self._lr_schedule(self.learning_rate)
        if self._restored_lr_state is not None:
            lr_schedule.load_state_dict(self._restored_lr_state)
        if self.profile_dir:
            os.makedirs(self.profile_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._profile_margin()
        try:
            self._train_epochs(lr_schedule)
        finally:
            self._stop_profiling()

    def _profile_margin(self):
        """A trivial kernel, then the device idle for PROFILE_MARGIN_S, so
        that the trace opens and closes on an idle device: the tracer keeps
        only the device events inside its window on the host's clock."""
        if self.device.type == 'cuda':
            torch.zeros(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)
            time.sleep(PROFILE_MARGIN_S)

    def _stop_profiling(self):
        if self._profiler is not None:
            self._profile_margin()
            profiler, self._profiler = self._profiler, None
            profiler.stop()
            path = os.path.join(self.profile_dir, f'train_epoch_{self.epoch}.pt.trace.json')
            profiler.export_chrome_trace(path)
            self.logger.info('Profiler trace written to %s', path)

    def _fire(self, event, *args):
        """Runs a Callback hook of every callback; True when one asks to stop
        (``experiment_builder.py:1659``)."""
        stop = False
        for cb in self.callbacks:
            stop = bool(getattr(cb, event)(self, *args)) or stop
        return stop

    def _train_epochs(self, lr_schedule):
        """The epoch loop: divergence guard, checkpoints, validation, test,
        LR stepping and the callbacks (``experiment_builder.py:1666``)."""
        self._fire('on_train_begin')
        self.train_loader.set_epoch(self.start_epoch - 1)
        for self.epoch in range(self.start_epoch, self.end_epoch + 1):
            self._fire('on_epoch_begin', self.epoch)
            gen_train_output = self.epoch % self.train_output_interval == 0
            epoch_train_dir = os.path.join(self.experiment_dir, 'train', f'epoch_{self.epoch}')
            train_loss = self.train_epoch(self.train_loader, lr_schedule,
                                          gen_output=gen_train_output, out_dir=epoch_train_dir)
            self.logger.info('epoch %2d: train loss %.6f (batches: %s)', self.epoch, train_loss,
                             ', '.join(f'{x:.6f}' for x in self.train_losses[self.epoch]))
            # A non-finite loss means the run diverged: stop before
            # overwriting good checkpoints.
            if not np.isfinite(train_loss):
                raise FloatingPointError(f'Training diverged: epoch {self.epoch} loss '
                                         f'{train_loss}; reduce --learning_rate or inspect '
                                         'the data')
            # The trace covers the first epoch.
            self._stop_profiling()

            if self.epoch % self.model_checkpoint_interval == 0:
                path = self.model.save_parameters(self.experiment_dir, self.epoch)
                checkpointing.save_training_state(
                    checkpointing.training_state_path_for(path), **self.loop.jax_state(),
                    extra={'lr_schedule': lr_schedule.state_dict()})
                self.logger.info('epoch %2d: saved %s', self.epoch, path)
                if self.ema_decay:
                    self.loop.ema_model.save_parameters(self.experiment_dir, f'{self.epoch}_ema')
                if self.keep_checkpoints > 0:
                    self._prune_checkpoints(self.keep_checkpoints)

            stop = False
            if self.valid:
                val_loss = self.run_valid(self.epoch % self.valid_output_interval == 0)
                if self.lr_schedule_name == 'plateau':
                    lr_schedule.step(metrics=val_loss)
                stop = self._fire('on_valid_end', self.epoch, float(val_loss))

            if self.test and self.epoch % self.test_output_interval == 0:
                self.run_test()

            if self.lr_schedule_name in lr_schedules.EPOCH_LR_SCHEDULES:
                lr_schedule.step()
            if self._fire('on_epoch_end', self.epoch, float(train_loss)) or stop:
                self.logger.info('epoch %2d: stopping early (callback request)', self.epoch)
                break
        self._fire('on_train_end')

    # ----------------------------------------------------------------- valid

    def valid_epoch(self, data_loader, gen_output=False, out_dir=None):
        r"""Evaluates once over all batches without a gradient; validation
        uses the EMA parameters when they are kept (``experiment_builder.py:1786``)."""
        use_ema = bool(self.ema_decay)
        model = self.loop.ema_model if use_ema else self.model
        model.mode = self.model.mode = 'valid'
        self.model.metrics.reset_state('valid')
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

        num_batches = len(data_loader)
        pbar = _logging.ProgressBar(num_batches, print_interval=self.log_interval)
        losses = []
        for i, features in zip(pbar, data_loader):
            self.model.step = (self.epoch - 1) * num_batches + i + 1
            batch_loss, output_features = self.loop.eval_step(features, use_ema=use_ema)
            losses.append(batch_loss)
            self.model.metrics.accumulate('valid', loss=batch_loss)
            pbar.maybe_print('valid', self.epoch, lambda: dict(
                batch_loss=utils.format_float_tensor(batch_loss),
                **self.model.metrics.results_as_str_dict('valid')))
            if gen_output:
                model.analysis_for_valid_batch(features, output_features, out_dir=out_dir,
                                               **self.analysis_kwargs)
        if gen_output:
            model.analysis_for_valid_epoch(out_dir=out_dir, **self.analysis_kwargs)
        if out_dir:
            file_io.save_json(self.model.metrics.results_as_json_dict('valid'),
                              os.path.join(out_dir, 'metrics.json'))
        self._log_metrics_to_tensorboard('valid')
        model.mode = self.model.mode = ''
        if not losses:
            return 0.0
        return float(torch.stack(losses).double().mean().cpu())

    def run_valid(self, gen_output):
        r"""Validation of the current epoch (``experiment_builder.py:1915``)."""
        out_dir = os.path.join(self.experiment_dir, 'valid', f'epoch_{self.epoch}')
        valid_loss = self.valid_epoch(self.valid_loader, gen_output=gen_output, out_dir=out_dir)
        self.logger.info('epoch %2d: valid loss %.6f', self.epoch, valid_loss)
        return valid_loss

    # ------------------------------------------------------------------ test

    def test_epoch(self, data_loader, out_dir=None):
        r"""Predicts every batch without a loss and runs the test analysis
        hooks (the acoustic models write ``synth/{name}.wav``), with the EMA
        parameters when they are kept; writes the test metrics to
        ``metrics.json`` (``experiment_builder.py:1931-1970``)."""
        use_ema = bool(self.ema_decay)
        model = self.loop.ema_model if use_ema else self.model
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        model.mode = self.model.mode = 'test'
        self.model.metrics.reset_state('test')

        num_batches = len(data_loader)
        pbar = _logging.ProgressBar(num_batches, print_interval=self.log_interval)
        for i, features in zip(pbar, data_loader):
            self.model.step = (self.epoch - 1) * num_batches + i + 1
            output_features = self.loop.predict_step(features, use_ema=use_ema)
            model.analysis_for_test_batch(features, output_features, out_dir=out_dir,
                                          **self.analysis_kwargs)
        model.analysis_for_test_epoch(out_dir=out_dir, **self.analysis_kwargs)
        if out_dir:
            file_io.save_json(self.model.metrics.results_as_json_dict('test'),
                              os.path.join(out_dir, 'metrics.json'))
        model.mode = self.model.mode = ''

    def run_test(self):
        r"""Generation for the current epoch into ``test/epoch_{N}``
        (``experiment_builder.py:1972-1978``)."""
        out_dir = os.path.join(self.experiment_dir, 'test', f'epoch_{self.epoch}')
        self.logger.info('epoch %2d: Running synthesis for the test set into %s', self.epoch,
                         out_dir)
        self.test_epoch(self.test_loader, out_dir=out_dir)

    # ------------------------------------------------------------------- run

    def _run_batch_size_search(self):
        """``--search_batch_size``: the largest batch whose measured train
        step fits the limit, instead of training (``experiment_builder.py:1982``);
        writes ``batch_size_search.txt``. Each probe is one full train step
        at learning rate 0 on the first batch's rows, repeated to size."""
        limit_bytes = int(self.search_batch_size * 2 ** 30)
        probe_batch = next(iter(self.train_loader))
        self.model.mode = 'train'
        self.model.metrics.reset_state('train')
        try:
            best, probes, failures = memory.search_train_batch_size(self.loop, probe_batch,
                                                                    limit_bytes)
        finally:
            self.model.mode = ''
        max_len = max((v.shape[1] for v in probe_batch.values()
                       if isinstance(v, np.ndarray) and v.ndim >= 2), default=None)
        lines = [f'Batch-size capacity search: limit {self.search_batch_size:g} GiB '
                 f'({limit_bytes} bytes) for the train step of {type(self.model).__name__} on '
                 f'{torch.cuda.get_device_name(self.device)}', '',
                 f"Probed at the first batch's padded length (max_len={max_len}); longer "
                 'batches take more: leave headroom.', '']
        if best is None:
            lines.append(f'No batch size fits: even batch {min(probes) if probes else 1} '
                         'exceeds the limit.')
        else:
            lines.append(f'Largest fitting batch size: {best}')
        above = sorted(b for b in probes if best is None or b > best)
        if above:
            nxt = above[0]
            why = failures.get(nxt) or (f'measured peak {probes[nxt] / 2 ** 20:.1f} MiB, '
                                        'over the memory limit')
            lines.append(f'Next size probed above it: {nxt}: {why}')
            if nxt in failures and 'batch limit' in failures[nxt]:
                lines.append("The kernel's batch limit, not memory, ended the search.")
        lines += ['', 'Probes (batch size -> measured peak; "-" = the probe raised):']
        for b in sorted(probes):
            peak = probes[b]
            lines.append(f'  {b:>6}: ' + (f'- ({failures.get(b)})' if peak is None
                                          else f'{peak / 2 ** 20:.1f} MiB'))
        path = os.path.join(self.experiment_dir, 'batch_size_search.txt')
        with open(path, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        self.logger.info('Batch-size search: largest fitting batch = %s (limit %.3g GiB, %d '
                         'probes; %s)', best, self.search_batch_size, len(probes), path)
        return best

    def _run_lr_find(self):
        """``--find_lr``: the exponential LR range test (Smith 2015) instead
        of training (``experiment_builder.py:2054-2174``): real train steps
        with the learning rate swept from MIN to MAX, a bias-corrected moving
        average of the loss, an early stop when it passes 4x its best, the
        steepest-descent suggestion, ``lr_find.json`` and (with matplotlib)
        ``lr_find.png``. The probe steps consume the parameters; nothing is
        saved."""
        parts = [p.strip() for p in str(self.find_lr).split(',')]
        if len(parts) not in (2, 3):
            raise ValueError(f"--find_lr takes 'MIN,MAX[,STEPS]', got {self.find_lr!r}")
        lr_min, lr_max = float(parts[0]), float(parts[1])
        steps = int(parts[2]) if len(parts) == 3 else 100
        if not (0 < lr_min < lr_max) or steps < 10:
            raise ValueError(f'--find_lr needs 0 < MIN < MAX and STEPS >= 10, got '
                             f'{self.find_lr!r}')

        self.model.mode = 'train'
        self.model.metrics.reset_state('train')
        records = []
        beta = 0.98
        avg, best = 0.0, float('inf')
        stop_reason = f'completed all {steps} steps'
        try:
            done = False
            while not done:
                pass_start = len(records)
                for features in self.train_loader:
                    i = len(records)
                    if i >= steps:
                        done = True
                        break
                    lr = lr_min * (lr_max / lr_min) ** (i / max(steps - 1, 1))
                    loss, _ = self.loop.train_step(features, lr)
                    raw = float(loss)
                    if not np.isfinite(raw):
                        records.append({'lr': lr, 'loss': None, 'smoothed': None})
                        stop_reason = f'stopped at step {i}: non-finite loss at lr {lr:.3g}'
                        done = True
                        break
                    avg = beta * avg + (1 - beta) * raw
                    smoothed = avg / (1 - beta ** (i + 1))
                    records.append({'lr': lr, 'loss': raw, 'smoothed': smoothed})
                    best = min(best, smoothed)
                    if i >= 10 and smoothed > best + 4 * abs(best) + 1e-12:
                        stop_reason = (f'stopped at step {i}: smoothed loss {smoothed:.4g} '
                                       f'diverged above best {best:.4g} at lr {lr:.3g}')
                        done = True
                        break
                if not done and len(records) == pass_start:
                    raise RuntimeError('--find_lr: the train loader yielded no batches; '
                                       'nothing to sweep')
        finally:
            self.model.mode = ''

        finite = [r for r in records if r['smoothed'] is not None]
        suggestion = None
        if len(finite) >= 5:
            lrs = np.array([r['lr'] for r in finite])
            smooth = np.array([r['smoothed'] for r in finite])
            # The steepest descent of the smoothed curve in log-lr, at or
            # before its minimum.
            lo = int(np.argmin(smooth)) + 1
            grad = np.gradient(smooth[:lo], np.log(lrs[:lo])) if lo >= 3 else None
            if grad is not None and np.isfinite(grad).any():
                suggestion = float(lrs[:lo][int(np.nanargmin(grad))])

        result = {'lr_min': lr_min, 'lr_max': lr_max, 'steps_requested': steps,
                  'steps_run': len(records), 'stop_reason': stop_reason,
                  'suggestion': suggestion, 'records': records}
        with open(os.path.join(self.experiment_dir, 'lr_find.json'), 'w') as f:
            json.dump(result, f, indent=2)
        if len(finite) >= 2:
            if plotting.matplotlib_available():
                self._plot_lr_find(finite, suggestion)
            else:
                self.logger.warning('lr_find.png not written: matplotlib is not installed')
        if suggestion:
            self.logger.info('LR range test: suggestion %.3g (steepest smoothed descent; %s); '
                             'details in lr_find.json', suggestion, stop_reason)
        else:
            self.logger.info('LR range test: no confident suggestion (%s); inspect '
                             'lr_find.json', stop_reason)
        return result

    def _plot_lr_find(self, finite, suggestion):
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot([r['lr'] for r in finite], [r['loss'] for r in finite], alpha=0.35,
                label='loss')
        ax.plot([r['lr'] for r in finite], [r['smoothed'] for r in finite], label='smoothed')
        if suggestion:
            ax.axvline(suggestion, color='tab:red', ls='--', label=f'suggestion {suggestion:.2e}')
        ax.set_xscale('log')
        ax.set_xlabel('learning rate')
        ax.set_ylabel('train loss')
        ax.legend()
        fig.savefig(os.path.join(self.experiment_dir, 'lr_find.png'), bbox_inches='tight')
        plt.close(fig)

    def _plot_metrics(self):
        """``metrics.pdf`` of every visible metric (``experiment_builder.py:2186``),
        or a warning that it was not written without matplotlib. Returns
        whether it was written."""
        if not plotting.matplotlib_available():
            self.logger.warning('metrics.pdf not written: matplotlib is not installed')
            return False
        names = [name for name, metric in self.model.metrics['all'].items() if not metric.hidden]
        plotting.plot_experiment(self.experiment_name, names, self.experiments_base, save=True)
        return True

    def _save_interrupted(self):
        """The emergency checkpoint of an interrupted run,
        ``epoch_{N}_interrupted.npz`` and its sidecar, which ``latest``
        never picks (``experiment_builder.py:2190-2215``)."""
        try:
            path = self.model.save_parameters(self.experiment_dir,
                                              f'{max(self.epoch, 1)}_interrupted')
            checkpointing.save_training_state(checkpointing.training_state_path_for(path),
                                              **self.loop.jax_state())
            self.logger.info('Interrupted: emergency checkpoint saved to %s', path)
        except Exception:  # noqa: BLE001 - the interrupt goes on either way
            self.logger.exception('Emergency checkpoint failed')

    def run_experiment(self):
        r"""Runs every procedure requested (``experiment_builder.py:2175``):
        ``--find_lr`` or ``--search_batch_size`` instead of training, else
        training (then ``metrics.pdf`` with validation; on an interrupt, the
        emergency checkpoint first), or validation and testing alone."""
        try:
            if self.train and self.find_lr:
                return self._run_lr_find()
            if self.train and self.search_batch_size > 0:
                return self._run_batch_size_search()
            if self.train:
                try:
                    self.run_train()
                except KeyboardInterrupt:
                    self._save_interrupted()
                    if self.valid:
                        self._plot_metrics()
                    raise
                if self.valid:
                    self._plot_metrics()
            else:
                if self.valid:
                    self.run_valid(gen_output=True)
                if self.test:
                    self.run_test()
        finally:
            if self.model.tensorboard is not None:
                self.model.tensorboard.close()
