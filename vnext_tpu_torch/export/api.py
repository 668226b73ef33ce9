"""Model export (reference surface: detectron2/export — Caffe2Tracer/torchscript).

The port's deployable artifact is a ``torch.export`` program saved as ``.pt2``,
where the JAX package serializes StableHLO (``vnext_tpu.export``). The
hand-written kernels are the operators ``torch.ops.vnext.*`` (registered by
``vnext_tpu_torch.ops``): a traced graph holds them as single nodes, and the
loaded program runs each one's CUDA implementation (the kernel, counted on its
launch counter) on the card and its plain version on the CPU. Loading needs the
operators registered, which :func:`load_exported` sees to.
"""

from __future__ import annotations

import collections
import contextlib
import os
from typing import Any, Callable, Dict, Sequence, Union

import torch

# the kernels' plain versions, by module: a trace reaches them only where a
# wrapper bypasses its operator (an operator's CPU implementation, which calls
# them, is never entered by a trace: the fake function is)
PLAIN_VERSIONS = {"ms_deform_attn": ("ms_deform_attn_plain", "ms_deform_attn_core_plain", "_bilinear_sum"),
                  "encoder_epilogue": ("encoder_epilogue_plain",), "stem_conv": ("stem_conv_plain",)}


def _register_ops() -> None:
    from ..ops import encoder_epilogue, ms_deform_attn, stem_conv  # noqa: F401  (registers torch.ops.vnext)


class _Function(torch.nn.Module):
    """A function of tensors as a module, so that ``torch.export`` can take it."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn_or_module: Union[torch.nn.Module, Callable], example_args: Sequence[Any],
                   ) -> torch.export.ExportedProgram:
    """``torch.export.export`` of a module (or of a function of tensors, which
    may close over a module) at the example arguments' static shapes, under
    ``torch.no_grad()`` with every parameter's ``requires_grad`` off for the
    trace (restored after), as an inference program is served."""
    _register_ops()
    module = fn_or_module if isinstance(fn_or_module, torch.nn.Module) else _Function(fn_or_module)
    params = list(module.parameters())
    flags = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(False)
        with torch.no_grad():
            return torch.export.export(module, tuple(example_args))
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(exported, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """A ``.pt2`` program; call ``.module()(*args)`` to run it."""
    _register_ops()
    return torch.export.load(path)


def vnext_op_counts(exported: torch.export.ExportedProgram) -> Dict[str, int]:
    """How many nodes of each ``vnext::`` operator the graph holds, by name
    (``msda_fwd``, ``msda_fwd_loc``, ``stem_conv``, ``encoder_epilogue``)."""
    counts: Dict[str, int] = collections.Counter()
    for node in exported.graph.nodes:
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload) \
                and node.target.namespace == "vnext":
            counts[node.target._opname] += 1
    return dict(counts)


@contextlib.contextmanager
def plain_versions_refused():
    """Inside, a call of any kernel's plain version raises ``RuntimeError``.
    Around ``export_program`` it shows that the graph holds the operators and
    none of the plain versions (a configured plain route, ``TPU.MSDA_IMPL``
    "jnp", raises too)."""
    import importlib

    saved = []

    def refuse(name):
        def fn(*args, **kwargs):
            raise RuntimeError(f"{name}, a kernel's plain version, was reached inside plain_versions_refused()")
        return fn

    try:
        for mod_name, names in PLAIN_VERSIONS.items():
            mod = importlib.import_module(f"vnext_tpu_torch.ops.{mod_name}")
            for name in names:
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, refuse(f"{mod_name}.{name}"))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
