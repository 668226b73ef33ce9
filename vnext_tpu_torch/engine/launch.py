"""Launch of the entry point.

Counterpart of ``vnext_tpu.engine.launch.launch``, single-process: the port
runs on one card in one process until its distribution is ported (ROADMAP
Queue 1, item 12), so more than one machine or GPU raises.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence


def launch(
    main_func: Callable,
    num_gpus_per_machine: int = 0,
    num_machines: int = 1,
    args: Sequence[Any] = (),
) -> Any:
    """``main_func(*args)`` in this process. ``num_gpus_per_machine`` 0 or 1 and
    one machine; anything more raises ``NotImplementedError``."""
    if num_machines > 1 or num_gpus_per_machine > 1:
        raise NotImplementedError(
            f"{num_machines} machine(s) x {num_gpus_per_machine} GPU(s): the port runs one process on "
            "one card until its distribution is ported (ROADMAP Queue 1, item 12)")
    return main_func(*args)
