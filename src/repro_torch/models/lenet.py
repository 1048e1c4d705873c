"""LeNet with exactly 431,080 learnable parameters — the paper's §5 model.

Caffe-LeNet variant: conv(1->20,5x5) -> maxpool2 -> conv(20->50,5x5) ->
maxpool2 -> fc(800->500) -> fc(500->10).
520 + 25,050 + 400,500 + 5,010 = 431,080 params.

The public face keeps the JAX reference's layouts, so weights and flat
vectors carry across unchanged: NHWC images, HWIO conv weights,
``(din, dout)`` dense weights, the activation flattened in NHWC order
before ``f1``, and the flat vector in ``ravel_pytree`` order (dict keys
sorted: ``c1.b, c1.w, c2.b, c2.w, f1.b, f1.w, f2.b, f2.w``). Inside,
the convolutions run in torch's NCHW/OIHW.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.paper_lenet import LeNetConfig
from repro_torch.core.ledger import FlatLayout, layout_of
from repro_torch.data.partition import agent_batch
from repro_torch.device import resolve as resolve_device
from repro_torch.models.model import classifier_loss

SHAPES = {
    "c1": {"w": (5, 5, 1, 20), "b": (20,)},
    "c2": {"w": (5, 5, 20, 50), "b": (50,)},
    "f1": {"w": (800, 500), "b": (500,)},
    "f2": {"w": (500, 10), "b": (10,)},
}


def init_lenet(generator: torch.Generator, cfg: LeNetConfig = LeNetConfig(),
               device="cuda"):
    """He-style normal init with zero biases, as the reference's (the
    numbers differ: torch cannot reproduce ``jax.random``; carry JAX
    weights over with :func:`params_from_jax` where they must agree).
    ``generator`` is a CPU generator; the draws are moved to ``device``."""
    device = resolve_device(device)

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator) * fan_in ** -0.5
                ).to(device)

    out = {}
    for name, shp in SHAPES.items():
        fan_in = int(np.prod(shp["w"][:-1]))
        out[name] = {"w": normal(shp["w"], fan_in),
                     "b": torch.zeros(shp["b"], device=device)}
    return out


def _maxpool2(x):
    """2x2 max pool of an NCHW map; ``amax`` splits the gradient evenly
    between tied maxima, as ``jnp.max`` does."""
    b, c, h, w = x.shape
    return torch.amax(x.reshape(b, c, h // 2, 2, w // 2, 2), dim=(3, 5))


def apply_lenet(params, images):
    """images: (B, 28, 28, 1) NHWC -> logits (B, 10)."""
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(x, params["c1"]["w"].permute(3, 2, 0, 1)) \
        + params["c1"]["b"][:, None, None]
    x = _maxpool2(F.relu(x))                        # (B,20,12,12)
    x = F.conv2d(x, params["c2"]["w"].permute(3, 2, 0, 1)) \
        + params["c2"]["b"][:, None, None]
    x = _maxpool2(F.relu(x))                        # (B,50,4,4)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
    x = F.relu(x @ params["f1"]["w"] + params["f1"]["b"])
    return x @ params["f2"]["w"] + params["f2"]["b"]


def param_count(params) -> int:
    return sum(l.numel() for sub in params.values() for l in sub.values())


def lenet_layout() -> FlatLayout:
    """The flat layout of the LeNet parameters (ravel_pytree order)."""
    return layout_of({k: {kk: torch.empty(s, device="meta")
                          for kk, s in v.items()}
                      for k, v in SHAPES.items()})


def params_from_jax(tree) -> dict:
    """JAX parameters (nested dicts of arrays) -> the same nested dicts of
    f32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def flat_from_jax(flat) -> torch.Tensor:
    """A JAX flat iterate (ravel_pytree order) -> (P,) f32 CPU tensor."""
    return torch.from_numpy(np.array(flat, np.float32).reshape(-1))


class AgentGradFn:
    """The §5 agent-side gradient ``grad_fn(j, x, rng) -> (P,)`` host f32
    numpy: agent j draws a batch from its own data with its own stream
    ``np.random.default_rng(100 + j)`` (the engine's ``rng`` is not
    touched), and returns the gradient of the unweighted mean
    cross-entropy at the flat iterate ``x``. ``rngs`` is exposed so a
    checkpoint can carry the batch streams."""

    def __init__(self, agent_sets, batch_size: int, device):
        self.agent_sets = agent_sets
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.layout = lenet_layout()
        self.rngs = [np.random.default_rng(100 + j)
                     for j in range(len(agent_sets))]

    def __call__(self, j: int, x_vec, rng) -> np.ndarray:
        xb, yb = agent_batch(self.agent_sets[j], self.batch_size,
                             self.rngs[j])
        flat = torch.as_tensor(np.asarray(x_vec, np.float32),
                               device=self.device).requires_grad_(True)
        logits = apply_lenet(self.layout.unflatten(flat),
                             torch.as_tensor(xb, device=self.device))
        loss = classifier_loss(logits, torch.as_tensor(yb,
                                                       device=self.device),
                               torch.ones(len(yb), device=self.device))
        (grad,) = torch.autograd.grad(loss, flat)
        return grad.cpu().numpy()


def make_agent_grad_fn(agent_sets, batch_size: int, *, device="cuda",
                       flat0=None, seed: int = 0):
    """(grad_fn, flat0, unravel) for the §5 experiment, the counterpart of
    ``benchmarks/comm_time.py:make_agent_grad_fn``. ``flat0`` (the initial
    flat iterate) is carried in (e.g. from JAX via :func:`flat_from_jax`)
    or drawn with :func:`init_lenet` from ``seed``; it is returned on
    ``device``."""
    grad_fn = AgentGradFn(agent_sets, batch_size, device)
    if flat0 is None:
        flat0 = grad_fn.layout.flatten(
            init_lenet(torch.Generator().manual_seed(seed),
                       device=grad_fn.device))
    return (grad_fn, torch.as_tensor(flat0, device=grad_fn.device),
            grad_fn.layout.unflatten)
