"""Time-correlated small-scale fading: first-order Gauss-Markov (AR(1))
evolution of the complex channel coefficients.

The complex coefficient h ~ CN(0, 1) evolves as

    h[t+1] = rho * h[t] + sqrt(1 - rho^2) * w,   w ~ CN(0, 1)

which keeps the Rayleigh marginal exactly (|h|^2 stays Exp(1)) while giving
correlation E[h[t+1] h*[t]] = rho between re-planning epochs -- the property
the online planner's warm start exploits.

Each function that draws takes a torch.Generator and has a deterministic
core (the ``*_from`` function) that takes the noise as tensors, so the same
standard-normal draws give the reference's coefficients.
"""
from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor
# sqrt(0.5) rounded to float32 (IEEE sqrt is correctly rounded, so numpy's
# equals the device's), computed once: no tensor is read per call.
_SQRT_HALF = float(np.sqrt(np.float32(0.5)))


def coeffs_from(zr: Tensor, zi: Tensor) -> Tensor:
    """CN(0, 1) coefficients from two standard-normal draws: (zr + i zi) / sqrt(2)
    in float32 parts, complex64."""
    return torch.complex(zr.float() * _SQRT_HALF, zi.float() * _SQRT_HALF)


def normal_pair(gen: torch.Generator, shape) -> tuple[Tensor, Tensor]:
    """The two standard-normal draws behind one set of coefficients."""
    dev = gen.device
    return (torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev))


def init_coeffs(gen: torch.Generator, shape) -> Tensor:
    """CN(0, 1) coefficients: |h|^2 ~ Exp(1), matching make_env's marginal."""
    return coeffs_from(*normal_pair(gen, shape))


def gauss_markov_from(h: Tensor, w: Tensor, rho) -> Tensor:
    """One AR(1) step given the innovation w (CN(0, 1) coefficients); rho a
    float or a float32 tensor broadcasting against h (per member). A float
    becomes a float32 scalar by a fill on h's device, not a copy from the
    host (a CUDA graph may capture the step)."""
    if isinstance(rho, Tensor):
        rho = rho.to(device=h.device, dtype=torch.float32)
    else:
        rho = torch.full((), float(rho), dtype=torch.float32, device=h.device)
    return rho * h + torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0)) * w


def gauss_markov_step(gen: torch.Generator, h: Tensor, rho) -> Tensor:
    """One AR(1) step; rho in [0, 1] (1 = frozen channel, 0 = i.i.d.)."""
    return gauss_markov_from(h, init_coeffs(gen, h.shape), rho)


def power_gain(h: Tensor) -> Tensor:
    """|h|^2 as float32 (the linear power gain used by the channel model)."""
    return (h.real * h.real + h.imag * h.imag).float()


def jakes_rho(doppler_hz: float, dt_s: float) -> float:
    """Epoch-to-epoch correlation for Jakes' model, rho = J0(2 pi f_d dt).

    Small-argument Bessel series (enough terms for the x <= ~3 regime that
    matters here), clipped to [0, 1] in float32, as the reference rounds it
    -- beyond the first J0 zero the channel is effectively decorrelated for
    warm-start purposes.
    """
    x = 2.0 * math.pi * doppler_hz * dt_s
    if x >= 2.405:  # first J0 zero: treat faster motion as fully decorrelated
        return 0.0
    x2 = (x / 2.0) ** 2
    j0 = 1.0 - x2 + x2**2 / 4.0 - x2**3 / 36.0 + x2**4 / 576.0
    return float(np.clip(np.float32(j0), np.float32(0.0), np.float32(1.0)))
