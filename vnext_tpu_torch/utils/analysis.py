"""Model analysis: FLOPs, activations and parameter counts (reference surface:
detectron2/utils/analysis.py:55-158, tools/analyze_model.py).

The port's counterpart of ``vnext_tpu.utils.analysis``. The JAX package reads
FLOPs from XLA's cost analysis of the compiled program; here they come from
``torch.utils.flop_counter.FlopCounterMode``, which counts each operator by
its formula (2 operations per multiply-add of a product or convolution). The
hand-written kernels are the operators ``torch.ops.vnext.*``, whose formulas
``vnext_tpu_torch.ops`` registers beside them; without those the count would
silently leave out the kernels' work, so :func:`flop_count` reports it by
operator.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


def _flax_leaf(module: nn.Module, name: str, param: torch.Tensor) -> str:
    """The flax tree's name of a parameter: a rank >= 2 ``weight`` is a
    ``kernel``, a LayerNorm's or GroupNorm's ``weight`` a ``scale``; the rest
    (FrozenBN statistics, biases, embeddings) keep their names, as
    ``checkpoint/from_jax.py`` maps them."""
    from ..models.layers import GroupNorm, LayerNorm

    if name == "weight":
        if param.dim() >= 2:
            return "kernel"
        if isinstance(module, (LayerNorm, GroupNorm)):
            return "scale"
    return name


def _named_flax_parameters(model: nn.Module):
    """(dotted flax path, parameter) for every parameter of ``model``."""
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            prefix = f"{mod_name}." if mod_name else ""
            yield prefix + _flax_leaf(module, name, p), p


def parameter_count(model: nn.Module) -> int:
    return sum(p.numel() for _, p in model.named_parameters())


def parameter_count_table(model: nn.Module, max_depth: int = 2) -> str:
    """Hierarchical parameter counts, like the reference's parameter_count_table,
    by the flax tree's names (the JAX package's rows)."""
    rows: Dict[str, int] = {}
    for path, p in _named_flax_parameters(model):
        prefix = path.split(".")
        n = p.numel()
        for d in range(1, max_depth + 1):
            key = ".".join(prefix[:d])
            rows[key] = rows.get(key, 0) + n
        rows[""] = rows.get("", 0) + n
    lines = [f"{'module':50s} #params"]
    for key in sorted(rows):
        name = key if key else "(total)"
        lines.append(f"{name:50s} {rows[key] / 1e6:8.2f}M")
    return "\n".join(lines)


def flop_count(fn: Callable, *example_args) -> Dict:
    """FLOPs of one call of ``fn`` at the example arguments, under
    ``torch.no_grad()``: ``flops`` in all and ``by_operator`` (operator name ->
    FLOPs), the ``vnext.*`` kernels' operators among them."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*example_args)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "by_operator": by_op}


_ACTIVATION_OPS = ("aten.convolution", "aten._convolution", "aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")


class _ActivationCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if str(func.overloadpacket) in _ACTIVATION_OPS:
            self.total += out.numel()
        return out


def activation_count(fn: Callable, *example_args) -> int:
    """Total activations (elements output by convolution / matrix-product
    operators) of one call of ``fn`` at the example arguments.

    Semantics match the reference's ActivationCountAnalysis
    (detectron2/utils/analysis.py:103, fvcore) and the JAX package's count of
    ``conv_general_dilated`` and ``dot_general`` outputs; a kernel's operator is
    neither, as a Pallas call is neither there."""
    counter = _ActivationCounter()
    with torch.no_grad(), counter:
        fn(*example_args)
    return counter.total
