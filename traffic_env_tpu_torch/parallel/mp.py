"""The model-parallel split of a net's dense layers over the mp axis
(counterpart of ``traffic_env_tpu/parallel/mesh.py:shard_params`` with
``axis="mp"``).

The JAX package places every Dense kernel ``(in, out)`` with ``P(None,
"mp")`` and every bias with ``P("mp")``, and GSPMD inserts the
collectives.  Here :func:`shard_params` turns each ``nn.Linear`` of a
module into a column-parallel layer: this rank keeps its mp part of the
weight's rows (a torch weight is ``(out, in)``, so flax's ``out`` is dim
0) and of the bias, and the forward pass is the local linear followed by
an all-gather of the outputs over the mp group (``dist.mp_all_gather``).
Backward, each rank keeps its slice of the output gradient, so the
weight's gradient is exact per element, and the input gradient is the
sum of the ranks' parts (``dist.mp_all_reduce``).  Conv weights stay
whole, as the JAX package leaves its 4-D kernels; conv biases stay whole
too, since GSPMD reassembles them to the same values, but a 1-D or 2-D
leaf whose split dim does not divide by mp raises wherever the JAX
package's ``device_put`` does.

A split module's own ``state_dict`` holds this rank's parts (the
learners copy main into chooser and target part to part), and its
``load_state_dict`` takes either its parts or the whole tensors, which
it slices: a checkpoint or the JAX package's params (``interop.py``)
load into a split module.  :func:`full_state_dict` and
:func:`full_optimizer_state` gather the whole tensors over mp, so a
checkpoint of a split run is the unsplit run's and restores in one
process; :func:`load_optimizer_state` slices them again.
:func:`global_norm` is the gradient norm of the whole parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import dist


def _part(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's mp part of a whole tensor along ``dim``."""
    n = t.shape[dim] // dist.mp_size()
    return t.narrow(dim, dist.mp_rank() * n, n)


class _CopyToMP(torch.autograd.Function):
    """The identity forward; backward, the input gradient summed over
    the mp group (each rank's layer saw the whole input)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return dist.mp_all_reduce([grad.contiguous().clone()])[0]


class _GatherFromMP(torch.autograd.Function):
    """The ranks' output parts concatenated on the last dim in mp order;
    backward, this rank's slice of the output gradient."""

    @staticmethod
    def forward(ctx, y):
        return dist.mp_all_gather(y, -1)

    @staticmethod
    def backward(ctx, grad):
        return _part(grad, -1).contiguous()


class ColumnParallelLinear(nn.Linear):
    """An ``nn.Linear`` split on its outputs by :func:`shard_params`:
    ``weight`` and ``bias`` hold this rank's ``out_features`` of the
    layer's ``full_out``.  The mp group is looked up when the layer
    runs, so the module deep-copies (qlearn's chooser and target)."""

    full_out: int

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(_CopyToMP.apply(x), self.weight, self.bias)
        return _GatherFromMP.apply(y)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        # ``state_dict`` is load_state_dict's own shallow copy
        for name in ("weight", "bias"):
            t = state_dict.get(prefix + name)
            if t is not None and t.shape[0] == self.full_out \
                    != self.out_features:
                state_dict[prefix + name] = _part(t)
        super()._load_from_state_dict(state_dict, prefix, *args)


def shard_params(module: nn.Module, axis: str | None = None) -> nn.Module:
    """Replicate ``module``'s parameters (``axis=None``, or an mp axis
    of 1: the module is unchanged) or split every ``nn.Linear`` of it on
    its outputs over the mp group (``axis="mp"``), in place: the same
    ``Parameter`` objects hold this rank's parts, so an optimizer made
    before the split holds them (split before its first step: Adam's
    state is made at the first step).  Raises ``ValueError`` naming the
    first 1-D or 2-D parameter whose outputs do not divide by mp, before
    anything is split.  Returns the module."""
    if axis is None or dist.mp_size() == 1:
        return module
    if axis != "mp":
        raise ValueError(f"axis={axis!r}: None or 'mp'")
    mp = dist.mp_size()
    for name, layer in module.named_modules():
        if isinstance(layer, ColumnParallelLinear):
            continue
        for leaf, p in layer.named_parameters(recurse=False):
            if p.dim() in (1, 2) and p.shape[0] % mp:
                raise ValueError(
                    f"{name + '.' if name else ''}{leaf} of shape "
                    f"{tuple(p.shape)}: {p.shape[0]} outputs do not "
                    f"divide over mp={mp}")
    for layer in module.modules():
        if type(layer) is nn.Linear:
            with torch.no_grad():
                for p in (layer.weight, layer.bias):
                    if p is not None:
                        p.data = _part(p.data).clone()
            layer.__class__ = ColumnParallelLinear
            layer.full_out = layer.out_features
            layer.out_features //= mp
    return module


def _split(module: nn.Module) -> dict:
    """``id`` of each parameter :func:`shard_params` split -> its whole
    row count."""
    return {id(p): layer.full_out for layer in module.modules()
            if isinstance(layer, ColumnParallelLinear)
            for p in (layer.weight, layer.bias) if p is not None}


def full_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` with every split weight and bias gathered
    over mp: the unsplit module's state dict (``module.state_dict()``
    itself when nothing is split)."""
    sd = module.state_dict()
    for name, layer in module.named_modules():
        if isinstance(layer, ColumnParallelLinear):
            for leaf in ("weight", "bias"):
                key = f"{name}.{leaf}" if name else leaf
                if key in sd:
                    sd[key] = dist.mp_all_gather(sd[key], 0)
    return sd


def _optimizer_params(opt: torch.optim.Optimizer) -> list:
    """The optimizer's parameters in its state dict's index order."""
    return [p for g in opt.param_groups for p in g["params"]]


def full_optimizer_state(opt: torch.optim.Optimizer,
                         module: nn.Module) -> dict:
    """``opt.state_dict()`` with the state of ``module``'s split
    parameters (Adam's moments) gathered over mp.  The live state is
    left as it is: the result holds new dicts."""
    sd = opt.state_dict()
    split, params = _split(module), _optimizer_params(opt)
    state = {}
    for i, s in sd["state"].items():
        p = params[i]
        if id(p) in split:
            s = {k: dist.mp_all_gather(v, 0)
                 if torch.is_tensor(v) and v.shape == p.shape else v
                 for k, v in s.items()}
        state[i] = s
    return {**sd, "state": state}


def load_optimizer_state(opt: torch.optim.Optimizer, sd: dict,
                         module: nn.Module) -> None:
    """``opt.load_state_dict(sd)``, where the state of ``module``'s
    split parameters may be whole (:func:`full_optimizer_state`'s): it
    is sliced to this rank's parts first."""
    split, params = _split(module), _optimizer_params(opt)
    state = {}
    for i, s in sd["state"].items():
        rows = split.get(id(params[int(i)]))
        if rows is not None:
            s = {k: _part(v) if torch.is_tensor(v) and v.dim()
                 and v.shape[0] == rows != params[int(i)].shape[0] else v
                 for k, v in s.items()}
        state[i] = s
    opt.load_state_dict({**sd, "state": state})


def global_norm(module: nn.Module, tensors) -> torch.Tensor:
    """``optax.global_norm`` of ``tensors``, one for each parameter of
    ``module`` in order (its gradients), over the whole parameters: the
    squares of a split parameter's part are summed over mp (one
    all-reduce of a vector).  Unsplit, the sum in parameter order."""
    sq = [torch.sum(g * g) for g in tensors]
    split = _split(module)
    idx = [i for i, p in enumerate(module.parameters()) if id(p) in split]
    if idx:
        total = dist.mp_all_reduce([torch.stack([sq[i] for i in idx])])[0]
        for j, i in enumerate(idx):
            sq[i] = total[j]
    return torch.sqrt(sum(sq))
