"""Seeded weights, made on the device in one draw and handed to both the
program and the reference.

A configuration file's ``init`` lists rules ``[pattern, kind, value]``; the
first whose regular expression matches a parameter's name (the port's names,
which are the JAX package's) sets how its uniform draw u in [-1, 1) becomes
the weight:

* ``fan_in``: u / sqrt(n), n the size of the axis named by ``value``
  (-1: the last axis, as an ``nn.Linear`` weight ``[out, in]`` has it);
* ``std``: u · sqrt(3) · value (a uniform of that standard deviation);
* ``scale``: u · value;
* ``const``: the constant ``value``;
* ``around``: value · (1 + 0.1 u).
"""

from __future__ import annotations

import math
import re

import torch

from bm.gen import device_generator


def make_weights(shapes: dict[str, tuple[int, ...]], rules: list, seed: int,
                 device) -> dict[str, torch.Tensor]:
    """Float32 weights by name for ``shapes``, all from one uniform draw of a
    generator on ``device`` seeded from ``seed``.  A name no rule matches
    raises."""
    total = sum(math.prod(s) for s in shapes.values())
    g = device_generator(seed, 10, device)
    flat = torch.rand(total, generator=g, device=device, dtype=torch.float32) * 2.0 - 1.0
    out, pos = {}, 0
    compiled = [(re.compile(p), kind, value) for p, kind, value in rules]
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = flat[pos:pos + n].reshape(shape)
        pos += n
        for pat, kind, value in compiled:
            if pat.search(name):
                break
        else:
            raise ValueError(f"no init rule matches parameter {name!r}")
        if kind == "fan_in":
            out[name] = u / math.sqrt(shape[int(value)])
        elif kind == "scale":
            out[name] = u * float(value)
        elif kind == "std":
            out[name] = u * (math.sqrt(3.0) * value)
        elif kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
        elif kind == "around":
            out[name] = value * (1.0 + 0.1 * u)
        else:
            raise ValueError(f"unknown init kind {kind!r} for {name!r}")
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into every parameter of ``model`` by name; a parameter
    without a weight, or a weight without a parameter, raises."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and parameters differ: {sorted(set(params) ^ set(weights))}")
    for name, p in params.items():
        p.copy_(weights[name])
