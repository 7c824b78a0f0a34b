"""The port's VAE path against the JAX package on the CPU: the latent
samplers, ``BaseVAE`` and ``VAEProsodyModel`` (its encoder's GRU final state,
the decoder, the single-stream MLPG, the KL annealing on the batch's
``global_step``), on the same seeded inputs and weights (carried by
``nn.load_jax_params``).

The two packages draw their noise from different generators, so each
comparison feeds both the same numpy draws: the samplers' transforms 1e-6
abs; ``predict`` (a given latent, and zeros) 1e-5 abs on the normalised
deltas (the GRU layer's bar) and 5e-5 on the MLPG lf0
(``tests/test_torch_gru_models.py``); the loss, with the posterior noise
given, 1e-5 relative at global steps 0, 500 and 2000, and its gradients
within 1e-4 of each one's largest value."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu import sampling as jsampling
from morgana_tpu.training import numeric_features, staged_value_and_grad

from morgana_tpu_torch import data as tdata
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch import sampling as tsampling
from morgana_tpu_torch.models import vae_prosody as tvae
from morgana_tpu_torch.training import TrainLoop as TLoop
from morgana_tpu_torch.training import build_optimizer as tbuild_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from vae_prosody import VAEProsodyModel as JModel
finally:
    sys.path.pop(0)

SAMPLER_ATOL = 1e-6
NET_ATOL = 1e-5
TRAJ_ATOL = 5e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
MODEL_KWARGS = {'z_dim': 4, 'hidden_size': 8}


def _jax_predict(jm, features):
    """The JAX model's predict on a numeric batch, jitted as its engine
    runs it."""
    def predict(params, batch):
        with jnn.bind(jm, params):
            return jm.predict(batch)
    return jax.jit(predict)(jnn.parameters(jm), features)


def test_sphere_sampler_matches_jax(monkeypatch):
    """The same Gaussian directions: points on the sphere of radius 1.5
    around a centre, as JAX's rsample makes them; the port's rsample draws
    from its generator, on the sphere, the same for the same seed."""
    rng = np.random.default_rng(1)
    centre = rng.normal(size=5).astype(np.float32)
    direction = rng.normal(size=(3, 2, 5)).astype(np.float32)
    monkeypatch.setattr(jax.random, 'normal', lambda key, shape: jnp.asarray(direction))
    want = jsampling.UniformSphereSurfaceSampler(centre, 1.5).rsample((3, 2),
                                                                       key=jax.random.PRNGKey(0))
    sampler = tsampling.UniformSphereSurfaceSampler(centre, 1.5)
    got = sampler.surface_point(torch.from_numpy(direction))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SAMPLER_ATOL)
    draws = [sampler.rsample((4,), generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert draws[0].shape == (4, 5)
    np.testing.assert_allclose(torch.linalg.norm(draws[0] - sampler.centre, dim=-1).numpy(), 1.5,
                               rtol=1e-6)
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


def test_ellipsoid_sampler_matches_jax(monkeypatch):
    """The same uniform draws for phi and the thetas: the ellipsoid points
    JAX's rsample makes (not offset by the centre, as in JAX)."""
    rng = np.random.default_rng(2)
    radii = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    u_phi, u_theta = rng.random((6, 1)), rng.random((6, 3))
    draws = iter((u_phi, u_theta))
    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape, minval, maxval: jnp.asarray(
        minval + next(draws) * (maxval - minval), jnp.float32))
    want = jsampling.UniformEllipsoidSurfaceApproximateSampler(np.zeros(5), radii).rsample(
        (6,), key=jax.random.PRNGKey(0))
    sampler = tsampling.UniformEllipsoidSurfaceApproximateSampler(np.zeros(5), radii)
    angles = torch.cat((2 * np.pi * torch.from_numpy(u_phi), np.pi * torch.from_numpy(u_theta)),
                       dim=-1).float()
    np.testing.assert_allclose(sampler.surface_point(angles).numpy(), np.asarray(want),
                               atol=SAMPLER_ATOL)
    assert sampler.rsample((6,), generator=torch.Generator().manual_seed(0)).shape == (6, 5)


def _models(root, seed=31):
    jnn.manual_seed(seed)
    jm, tm = JModel(**MODEL_KWARGS), tvae.VAEProsodyModel(**MODEL_KWARGS)
    tnn.load_jax_params(tm, jnn.state_dict(jm))
    for model in (jm, tm):
        model.normalisers = model.normaliser_sources()
        for normaliser in model.normalisers.values():
            normaliser.load_params('train', root)
        model.mode = 'train'
    dataset = tdata.FilesDataset(tm.train_data_sources(), 'train', 'train/train_file_id_list.scp',
                                 tm.normalisers, root)
    return jm, tm, tdata.collate([dataset[i] for i in range(3)])


@pytest.mark.parametrize('with_latent', [True, False], ids=['latent', 'zeros'])
def test_predict_matches_jax(voice_data, with_latent):
    """predict decodes the given latent, or zeros without one."""
    jm, tm, batch = _models(voice_data['data_root'])
    features = numeric_features(batch)
    if with_latent:
        features['latent'] = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    want = _jax_predict(jm, {k: jnp.asarray(v) for k, v in features.items()})
    tm.eval()
    with torch.no_grad():
        got = tm.predict({k: torch.from_numpy(v) for k, v in features.items()})
    assert sorted(got) == sorted(want) == ['lf0', 'normalised_lf0_deltas']
    for key, atol in (('normalised_lf0_deltas', NET_ATOL), ('lf0', TRAJ_ATOL)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize('global_step', [0, 500, 2000])
def test_loss_and_gradients_match_jax(voice_data, monkeypatch, global_step):
    """The posterior noise given to both: the train loss at the step (KL
    weight 0, 0.5 and 1 of kld_weight over the 1000 annealing steps) and
    its gradients against staged_value_and_grad; the port's eval_step at
    that step count gives the same loss."""
    jm, tm, batch = _models(voice_data['data_root'])
    noise = np.random.default_rng(4).normal(size=(3, 4)).astype(np.float32)
    monkeypatch.setattr(jm, 'sample', lambda mean, log_var: mean + jnp.exp(0.5 * log_var) * noise)
    monkeypatch.setattr(tm, 'sample', lambda mean, log_var: mean + torch.exp(0.5 * log_var)
                        * torch.from_numpy(noise))
    jbatch = dict(numeric_features(batch), global_step=jnp.asarray(global_step, jnp.int32))
    grad_fn = jax.jit(lambda p, b: staged_value_and_grad(jm, p, b, jax.random.PRNGKey(0)))
    jloss, _, _, want_g = grad_fn(jnn.parameters(jm), jbatch)
    loop = TLoop(tm, tbuild_optimizer('adam'))
    loop.step_count = global_step
    eval_loss, _ = loop.eval_step(batch)
    tloss, _ = loop.train_step(batch, 0.0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(eval_loss), float(jloss), rtol=LOSS_RTOL)
    for name, param in tm.named_parameters():
        want = np.asarray(want_g[name])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(param.grad.numpy() / scale, want / scale, atol=GRAD_RTOL,
                                   err_msg=name)


def test_sample_draws_from_the_model_generator(voice_data):
    """BaseVAE.sample draws from ``model.generator``: the same seed gives the
    same latent, and the train loop seeds it each step."""
    _, tm, batch = _models(voice_data['data_root'])
    mean, log_var = torch.zeros(2, 4), torch.zeros(2, 4)
    samples = []
    for seed in (5, 5, 6):
        tm.generator = torch.Generator().manual_seed(seed)
        samples.append(tm.sample(mean, log_var))
    assert torch.equal(samples[0], samples[1]) and not torch.equal(samples[0], samples[2])
    loop = TLoop(tm, tbuild_optimizer('adam'))
    loop.train_step(batch, 0.0)
    assert isinstance(tm.generator, torch.Generator)


def test_builder_test_writes_latent_samples(voice_data, tmp_path):
    """One epoch through the port's builder with --test: finite losses, and
    each test utterance's lf0 for 4 latents on the sphere under
    test/epoch_1/latent_samples/feats/lf0/, n_frames long."""
    root = voice_data['data_root']
    tvae.main(['--experiment_name', 'vae', '--experiments_base', str(tmp_path),
               '--data_root', root, '--train_id_list', 'train/train_file_id_list.scp',
               '--valid_id_list', 'valid/valid_file_id_list.scp',
               '--test_id_list', 'test/test_file_id_list.scp', '--test',
               '--test_output_interval', '1', '--batch_size', '4', '--end_epoch', '1',
               '--model_kwargs', str(MODEL_KWARGS), '--device', 'cpu'])
    sample_dir = tmp_path / 'vae' / 'test' / 'epoch_1' / 'latent_samples' / 'feats' / 'lf0'
    with open(os.path.join(root, 'test', 'test_file_id_list.scp')) as f:
        ids = f.read().split()
    assert sorted(os.listdir(sample_dir)) == sorted(f'{utt}_sample{s}.npy' for utt in ids
                                                    for s in range(4))
    for utt in ids:
        n_frames = int(np.loadtxt(os.path.join(root, 'test', 'n_frames', f'{utt}.txt')))
        lf0 = [np.load(sample_dir / f'{utt}_sample{s}.npy') for s in range(4)]
        assert all(x.shape[0] == n_frames and np.isfinite(x).all() for x in lf0)
        assert not np.array_equal(lf0[0], lf0[1])
