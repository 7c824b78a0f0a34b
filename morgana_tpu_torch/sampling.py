"""Latent-space samplers for exploring a VAE's prior (counterpart of
``morgana_tpu/sampling.py``).

Where the JAX samplers take a PRNG key, these take an explicit
``torch.Generator`` (the default generator of the centre's device when it is
None) and draw on the centre's device. Each splits into its draw and a
transform of the draw (:meth:`UniformSphereSurfaceSampler.surface_point`,
:meth:`UniformEllipsoidSurfaceApproximateSampler.surface_point`), which
compute the JAX samplers' functions of the same draws.
"""
import math

import torch

__all__ = ['UniformSphereSurfaceSampler', 'UniformEllipsoidSurfaceApproximateSampler']


class UniformSphereSurfaceSampler(object):
    r"""Points uniformly on an n-sphere's surface (``sampling.py:21``): a
    normalised Gaussian direction scaled by ``radius``, offset by ``centre``."""

    def __init__(self, centre, radius):
        self.centre = torch.as_tensor(centre, dtype=torch.float32)
        self.dim = self.centre.shape[-1]
        self.radius = radius

    def surface_point(self, direction):
        """The point of a Gaussian ``direction`` (..., dim)."""
        return self.centre + self.radius * direction / torch.linalg.norm(direction, dim=-1,
                                                                          keepdim=True)

    def rsample(self, sample_shape=(), generator=None):
        direction = torch.randn(tuple(sample_shape) + (self.dim,), generator=generator,
                                device=self.centre.device)
        return self.surface_point(direction)

    sample = rsample


class UniformEllipsoidSurfaceApproximateSampler(object):
    r"""Points roughly uniformly on an n-ellipsoid's surface through the
    n-sphere angles (``sampling.py:40``); denser at the poles. As in the JAX
    package (and the reference), the points are not offset by ``centre``."""

    def __init__(self, centre, radii):
        self.centre = torch.as_tensor(centre, dtype=torch.float32)
        self.radii = torch.as_tensor(radii, dtype=torch.float32, device=self.centre.device)
        self.ndims = self.centre.shape[-1]

    def sample_angles(self, sample_shape=(), generator=None):
        """phi in [0, 2 pi) then ndims - 2 thetas in [0, pi)."""
        shape = tuple(sample_shape)
        device = self.centre.device
        phi = 2 * math.pi * torch.rand(shape + (1,), generator=generator, device=device)
        thetas = math.pi * torch.rand(shape + (max(0, self.ndims - 2),), generator=generator,
                                      device=device)
        return torch.cat((phi, thetas), dim=-1)

    def surface_point(self, angles):
        """The point of ``angles`` (..., ndims - 1)."""
        cumprod_sin = torch.cumprod(torch.sin(angles), dim=-1)
        pad = torch.ones_like(cumprod_sin[..., :1])
        cumprod_sin = torch.cat((pad, cumprod_sin), dim=-1)
        cos_padded = torch.cat((torch.cos(angles), pad), dim=-1)
        return self.radii * cumprod_sin * cos_padded

    def rsample(self, sample_shape=(), generator=None):
        return self.surface_point(self.sample_angles(sample_shape, generator))

    sample = rsample
