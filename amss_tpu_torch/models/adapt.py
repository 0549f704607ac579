"""The learned adaptive filterbank front and its autoencoder pretraining
(``amss_tpu/models/adapt.py``).

Analysis is a stride-s conv1d with L taps, which is ``frames @ enc``: kernel
B1 on a card, differentiable in ``enc``.  Then |z|, the sign of z kept for
synthesis, and a max-pool with argmax over time.  Synthesis unpools, puts the
sign back and runs ``overlap_add(z @ dec)``: kernel B2, differentiable in the
codes and in ``dec``.

Representation:
  codes  ``[B, T'', N]`` non-negative pooled magnitudes (what masks multiply)
  aux    {"sign": ``[B, T', N]``, "idx": ``[B, T'', N]`` int32, "t_frames": T'}

The parameters keep the JAX package's names and layouts (``enc [L, N]``,
``dec [N, L]``, ``smooth [smooth_len, 1]``), so weights carry across without
transposes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul
from amss_tpu_torch.ops.kernels.ola import decode_ola
from amss_tpu_torch.ops.metrics import si_sdr
from amss_tpu_torch.ops.pooling import max_pool_argmax, unpool_argmax
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig

_EPS = 1e-7


def gabor_bank(n_filters: int, filter_len: int) -> np.ndarray:
    """``[N, L]`` Hann-windowed cosines of spread frequencies and random
    phases (numpy seed 0), each of unit norm: the JAX package's init before
    its noise."""
    n = np.arange(filter_len)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * n / filter_len)
    freqs = np.linspace(0.02, 0.98, n_filters) * np.pi
    phases = np.random.default_rng(0).uniform(0, 2 * np.pi, n_filters)
    bank = window[None, :] * np.cos(freqs[:, None] * n[None, :] + phases[:, None])
    return (bank / np.linalg.norm(bank, axis=1, keepdims=True)).astype(np.float32)


class AdaptFrontEnd(nn.Module):
    """Learned conv1d analysis and synthesis filterbank."""

    def __init__(self, cfg: FrontConfig):
        super().__init__()
        if cfg.kind != "adapt":
            raise ValueError(f"AdaptFrontEnd needs kind 'adapt', got {cfg.kind!r}")
        self.cfg = cfg
        self.enc = nn.Parameter(torch.zeros(cfg.filter_len, cfg.n_filters))
        self.dec = nn.Parameter(torch.zeros(cfg.n_filters, cfg.filter_len))
        self.smooth = nn.Parameter(torch.zeros(cfg.smooth_len, 1))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The Gabor bank plus N(0, 0.05²) noise for ``enc`` and ``dec``, and
        N(1/smooth_len, 0.1²) for ``smooth``.  The noise comes from
        ``generator`` (a CPU generator) and cannot replay ``jax.random``."""
        c = self.cfg
        bank = torch.from_numpy(gabor_bank(c.n_filters, c.filter_len))

        def normal(*shape):
            return torch.randn(shape, generator=generator)

        self.enc.copy_(bank.T + 0.05 * normal(c.n_filters, c.filter_len).T)
        self.dec.copy_(bank + 0.05 * normal(c.n_filters, c.filter_len))
        self.smooth.copy_(normal(c.smooth_len, 1) * 0.1 + 1.0 / c.smooth_len)

    def encode(self, wave: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """``wave[..., T]`` -> (codes ``[..., T'', N]``, aux)."""
        c = self.cfg
        lead = wave.shape[:-1]
        z = framed_matmul(wave.reshape(-1, wave.shape[-1]), self.enc, c.stride)
        z = z.reshape(*lead, *z.shape[-2:])
        keep = (z.shape[-2] // c.pool) * c.pool  # trim T' to a multiple of pool
        z = z[..., :keep, :]
        codes, idx = max_pool_argmax(torch.abs(z), c.pool)
        return codes, {"sign": torch.sign(z), "idx": idx, "t_frames": keep}

    def features(self, codes: torch.Tensor) -> torch.Tensor:
        """Log of the codes after a causal depthwise smoothing over time, one
        kernel shared by all filters (a sum of shifted views: it is short)."""
        k = self.smooth[:, 0]
        klen, t = k.shape[0], codes.shape[-2]
        padded = F.pad(codes, (0, 0, klen - 1, 0))
        out = torch.zeros_like(codes)
        for i in range(klen):
            out = out + k[i] * padded[..., i : i + t, :]
        return torch.log(torch.clamp(out, min=0.0) + _EPS)

    def decode(self, codes: torch.Tensor, aux: dict, length: int) -> torch.Tensor:
        """codes ``[..., T'', N]`` with the mixture's aux -> ``[..., length]``."""
        c = self.cfg
        z = unpool_argmax(codes, aux["idx"], c.pool) * aux["sign"]
        lead = z.shape[:-2]
        y = decode_ola(z.reshape(-1, *z.shape[-2:]), self.dec, c.stride, length=length)
        return y.reshape(*lead, length)


class AdaptAutoencoder(nn.Module):
    """Reconstruction pretraining of the adaptive front: each clean source
    chunk autoencodes on its own, under −SI-SDR + 10·L2."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.kind != "adapt_ae":
            raise ValueError(f"AdaptAutoencoder needs kind 'adapt_ae', got {cfg.kind!r}")
        self.cfg = cfg
        self.front = AdaptFrontEnd(cfg.front)

    def init_parameters(self, generator: torch.Generator) -> None:
        self.front.init_parameters(generator)

    def loss(self, sources: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """sources ``[B, S, T]`` -> (loss, metrics)."""
        b, s, t = sources.shape
        wave = sources.reshape(b * s, t)
        codes, aux = self.front.encode(wave)
        recon = self.front.decode(codes, aux, t)
        neg_si = -si_sdr(recon, wave).mean()
        l2 = ((recon - wave) ** 2).mean()
        loss = neg_si + 10.0 * l2
        return loss, {"ae_loss": loss, "neg_si_sdr": neg_si, "l2": l2}

    def loss_from_batch(self, batch: dict, rng=None):
        """The trainer's entry point; nothing here depends on the key
        ``rng``."""
        return self.loss(batch["sources"])
