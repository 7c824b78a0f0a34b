"""Experiment orchestration: CLI flags and the train/valid lifecycle
(counterpart of ``morgana_tpu/experiment_builder.py``, its main training
path).

Each batch is one :meth:`~morgana_tpu_torch.training.TrainLoop.train_step`
on the device: on the GPU every LSTM layer runs kernel K1 forward (writing
its gate trace) and kernel K2 backward, every GRU layer kernels K3 and K4.
Outputs keep the JAX package's layout under
``{experiments_base}/{experiment_name}``: ``config.json``,
``checkpoints/epoch_{N}.npz`` (which the JAX package loads),
``train/epoch_{N}/metrics.json`` (with ``epoch_duration_s``, ``ms_per_step``
and ``frames_per_sec``), ``valid/epoch_{N}/metrics.json`` and ``log/``. Every
``--valid_output_interval`` epochs the validation runs the model's analysis
hooks (the acoustic models synthesise ``valid/epoch_{N}/synth/*.wav``);
``--test`` predicts the test set every ``--test_output_interval`` epochs, or
once from ``--checkpoint_path`` without training, through the test hooks
into ``test/epoch_{N}/``.

The flags are the main path's subset of the JAX package's; any other flag is
an argparse error. ``--device`` defaults to ``cuda`` and raises
:class:`~morgana_tpu_torch.device.DeviceError` without a GPU; ``--device
cpu`` runs the kernels' plain versions on the CPU.
"""
import argparse
import ast
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from morgana_tpu_torch import checkpointing
from morgana_tpu_torch import data
from morgana_tpu_torch import lr_schedules
from morgana_tpu_torch import utils
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.device import resolve_device
from morgana_tpu_torch.training import TrainLoop, build_optimizer

__all__ = ['ExperimentBuilder', 'add_boolean_arg', 'DictAction']

LOGGER_NAME = 'morgana_tpu_torch'


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


def _create_logger(experiment_dir):
    """The experiment's logger: INFO to stdout and everything to
    ``{experiment_dir}/log/{stamp}.log``. Repeated calls replace the
    handlers."""
    log_dir = os.path.join(experiment_dir, 'log')
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    while logger.handlers:
        handler = logger.handlers[-1]
        logger.removeHandler(handler)
        handler.close()
    stdout = logging.StreamHandler(sys.stdout)
    stdout.setLevel(logging.INFO)
    stdout.setFormatter(logging.Formatter('%(message)s'))
    logger.addHandler(stdout)
    log_file = logging.FileHandler(
        os.path.join(log_dir, time.strftime('%y_%m_%d-%H_%M_%S') + '.log'))
    log_file.setFormatter(logging.Formatter('%(asctime)s %(levelname)s %(message)s'))
    logger.addHandler(log_file)
    return logger


class ExperimentBuilder(object):
    r"""Runs training and validation of one model (``experiment_builder.py:112``).

    Parameters
    ----------
    model_class : morgana_tpu_torch.base_models.BaseModel subclass
    experiment_name : str
        Output directory name under ``experiments_base``.
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
                                 'step and LR-schedule state too, from the JAX package\'s '
                                 'epoch_{N}.train.pkl beside it.')

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
                            help='L2 regularisation added to the gradient (0 disables it).')
        parser.add_argument('--optimizer', dest='optimizer', type=str, default='adam',
                            help="Optimiser; the port has 'adam' (torch-Adam semantics).")
        parser.add_argument('--optimizer_kwargs', dest='optimizer_kwargs', action=DictAction,
                            type=str, default={}, help='Optimiser settings (b1, b2, eps), a '
                                                       'quoted dict literal.')
        parser.add_argument('--ema_decay', dest='ema_decay', type=float, default=0.,
                            help='Decay of an exponential moving average of the parameters; '
                                 'when non-zero, validation uses the average.')
        parser.add_argument('--grad_clip_norm', dest='grad_clip_norm', type=float, default=0.,
                            help='If > 0, clip the global gradient norm before Adam.')

        parser.add_argument('--device', dest='device', type=str, default='cuda',
                            help="'cuda' (the default; an error without a GPU), 'cuda:N' or "
                                 "'cpu'.")
        parser.add_argument('--seed', dest='seed', type=int, default=1234567890,
                            help='Seed of the parameter init, the shuffle and dropout.')

        parser.add_argument('--model_checkpoint_interval', dest='model_checkpoint_interval',
                            type=int, default=1, help='Save a checkpoint every N epochs.')
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

    @classmethod
    def _parser(cls):
        parser = argparse.ArgumentParser(
            description='Experiment builder for the PyTorch/CUDA port of morgana_tpu.')
        cls.add_args(parser)
        return parser

    @classmethod
    def get_experiment_args(cls, argv=None):
        r"""Parses the command line (``argv``, default ``sys.argv[1:]``) into
        the args dict."""
        return vars(cls._parser().parse_args(argv))

    def __init__(self, model_class, experiment_name, **kwargs):
        settings = vars(self._parser().parse_args(['--experiment_name', experiment_name]))
        unknown = sorted(set(kwargs) - set(settings))
        if unknown:
            raise TypeError(f'ExperimentBuilder got settings the port does not have: {unknown}')
        settings.update(kwargs)
        self.settings = settings
        self.model_class = model_class
        self.experiment_name = experiment_name
        self.model_kwargs = settings['model_kwargs']
        self.analysis_kwargs = settings['analysis_kwargs']
        for name in ('train', 'valid', 'test', 'start_epoch', 'end_epoch', 'checkpoint_path',
                     'batch_size', 'learning_rate', 'lr_schedule_name', 'lr_schedule_kwargs',
                     'weight_decay', 'ema_decay', 'seed', 'model_checkpoint_interval',
                     'train_output_interval', 'valid_output_interval', 'test_output_interval',
                     'data_root', 'train_dir', 'valid_dir', 'test_dir', 'train_id_list',
                     'valid_id_list', 'test_id_list', 'normalisation_dir', 'experiments_base'):
            setattr(self, name, settings[name])

        self.device = resolve_device(settings['device'])

        self.experiment_dir = os.path.join(self.experiments_base, self.experiment_name)
        self.logger = _create_logger(self.experiment_dir)
        self._lr_schedule = lr_schedules.init_lr_schedule(self.lr_schedule_name,
                                                          **self.lr_schedule_kwargs)
        self.epoch = 0
        self.resolve_setting_conflicts()
        # Per-batch train losses of each epoch, fetched once at its end.
        self.train_losses = {}

        torch.manual_seed(self.seed)
        self.model = self.build_model(self.model_class, self.model_kwargs, self.checkpoint_path)
        normalisers = self.model.normaliser_sources()
        for normaliser in normalisers.values():
            normaliser.load_params(self.normalisation_dir, self.data_root)
        self.model.normalisers = normalisers

        ema_model = None
        if self.ema_decay:
            ema_model = self.build_model(self.model_class, self.model_kwargs, self.checkpoint_path)
            ema_model.normalisers = normalisers
            ema_model.metrics = self.model.metrics  # one handler collects every metric
        optimizer = build_optimizer(settings['optimizer'], weight_decay=self.weight_decay,
                                    grad_clip_norm=settings['grad_clip_norm'],
                                    **settings['optimizer_kwargs'])
        self.loop = TrainLoop(self.model, optimizer, ema_decay=self.ema_decay, seed=self.seed,
                              ema_model=ema_model)
        self._restored_lr_state = None
        if self.checkpoint_path and self.train:
            self.restore_training_state(self.checkpoint_path)
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
        self.model.finalise_init()

    def log_initial_setup(self):
        r"""Writes ``config.json`` (every setting) and ``model_summary.txt``;
        the settings also go to the log file."""
        os.makedirs(self.experiment_dir, exist_ok=True)
        with open(os.path.join(self.experiment_dir, 'model_summary.txt'), 'w') as f:
            f.write(str(self.model))
        self.logger.debug('settings: %s', json.dumps(self.settings, default=str))
        with open(os.path.join(self.experiment_dir, 'config.json'), 'w') as f:
            json.dump(self.settings, f, indent=4, default=str)

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

    def restore_training_state(self, checkpoint_path):
        r"""Exact resume (``experiment_builder.py:756-778``): when the JAX
        package's ``.train.pkl`` sidecar sits beside ``checkpoint_path``, Adam's
        state, the EMA parameters and the step count are taken from it, and
        the LR-schedule state at :meth:`run_train`. Without one, Adam starts
        afresh, as in the JAX package."""
        path = checkpointing.training_state_path_for(checkpoint_path)
        if not os.path.exists(path):
            return
        state = checkpointing.load_training_state(path)
        self.loop.restore_jax_state(state)
        self._restored_lr_state = (state.get('extra') or {}).get('lr_schedule')
        self.logger.info('Restored optimiser state from %s (step %d)', path,
                         self.loop.step_count)

    def load_data(self, data_sources, data_dir, id_list, normalisers=None, name='', shuffle=True):
        r"""The dataset and batching loader of one split (``experiment_builder.py:1233``)."""
        self.logger.info('Loading %s data using %s from %s/%s',
                         name, id_list, self.data_root, data_dir)
        dataset = data.FilesDataset(data_sources, data_dir, id_list, normalisers, self.data_root)
        return data.DataLoader(dataset, batch_size=self.batch_size, shuffle=shuffle,
                               seed=self.seed)

    # ----------------------------------------------------------------- train

    def train_epoch(self, data_loader, lr_schedule=None, gen_output=False, out_dir=None):
        r"""Trains once over all batches; writes the epoch's
        ``metrics.json`` with its timing. Returns the mean batch loss
        (``experiment_builder.py:1345``)."""
        self.model.mode = 'train'
        self.model.metrics.reset_state('train')
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

        num_batches = len(data_loader)
        epoch_start = time.perf_counter()
        losses, frames = self._train_batches(data_loader, lr_schedule, gen_output, out_dir,
                                             num_batches)
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
            if num_batches:
                epoch_metrics['ms_per_step'] = round(1e3 * duration / num_batches, 3)
            if frames:
                epoch_metrics['frames_per_sec'] = round(frames / duration, 1)
            file_io.save_json(epoch_metrics, os.path.join(out_dir, 'metrics.json'))
        self.model.mode = ''
        return float(np.mean(batch_losses)) if batch_losses else 0.0

    def _train_batches(self, data_loader, lr_schedule, gen_output, out_dir, num_batches):
        """One train step per batch (``experiment_builder.py:1426``). Returns
        the per-batch device losses and the number of frames trained on."""
        losses = []
        frames = 0.
        for i, features in enumerate(data_loader):
            self.model.step = (self.epoch - 1) * num_batches + i + 1
            if 'n_frames' in features:
                frames += float(np.sum(features['n_frames']))
            lr = lr_schedule.lr if lr_schedule is not None else self.learning_rate
            batch_loss, output_features = self.loop.train_step(features, lr)
            if lr_schedule is not None and self.loop.last_step_applied and \
                    self.lr_schedule_name in lr_schedules.BATCH_LR_SCHEDULES:
                lr_schedule.step()
            losses.append(batch_loss)
            self.model.metrics.accumulate(self.model.mode, loss=batch_loss)
            if gen_output:
                self.model.analysis_for_train_batch(features, output_features, out_dir=out_dir,
                                                    **self.analysis_kwargs)
        return losses, frames

    def run_train(self):
        r"""Trains from ``start_epoch`` to ``end_epoch`` (``experiment_builder.py:1628``)."""
        self.logger.info('epoch %2d: Beginning training', self.start_epoch)
        lr_schedule = self._lr_schedule(self.learning_rate)
        if self._restored_lr_state is not None:
            lr_schedule.load_state_dict(self._restored_lr_state)
        self._train_epochs(lr_schedule)

    def _train_epochs(self, lr_schedule):
        """The epoch loop: divergence guard, checkpoint, validation and LR
        stepping (``experiment_builder.py:1666``)."""
        self.train_loader.set_epoch(self.start_epoch - 1)
        for self.epoch in range(self.start_epoch, self.end_epoch + 1):
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

            if self.epoch % self.model_checkpoint_interval == 0:
                path = self.model.save_parameters(self.experiment_dir, self.epoch)
                self.logger.info('epoch %2d: saved %s', self.epoch, path)
                if self.ema_decay:
                    self.loop.ema_model.save_parameters(self.experiment_dir, f'{self.epoch}_ema')

            if self.valid:
                val_loss = self.run_valid(self.epoch % self.valid_output_interval == 0)
                if self.lr_schedule_name == 'plateau':
                    lr_schedule.step(metrics=val_loss)

            if self.test and self.epoch % self.test_output_interval == 0:
                self.run_test()

            if self.lr_schedule_name in lr_schedules.EPOCH_LR_SCHEDULES:
                lr_schedule.step()

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
        losses = []
        for i, features in enumerate(data_loader):
            self.model.step = (self.epoch - 1) * num_batches + i + 1
            batch_loss, output_features = self.loop.eval_step(features, use_ema=use_ema)
            losses.append(batch_loss)
            self.model.metrics.accumulate('valid', loss=batch_loss)
            if gen_output:
                model.analysis_for_valid_batch(features, output_features, out_dir=out_dir,
                                               **self.analysis_kwargs)
        if gen_output:
            model.analysis_for_valid_epoch(out_dir=out_dir, **self.analysis_kwargs)
        if out_dir:
            file_io.save_json(self.model.metrics.results_as_json_dict('valid'),
                              os.path.join(out_dir, 'metrics.json'))
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
        for i, features in enumerate(data_loader):
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

    def run_experiment(self):
        r"""Runs every procedure requested (``experiment_builder.py:2175``)."""
        if self.train:
            self.run_train()
        else:
            if self.valid:
                self.run_valid(gen_output=True)
            if self.test:
                self.run_test()
