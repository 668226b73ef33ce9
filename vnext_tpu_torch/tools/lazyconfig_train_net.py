"""Training entry for python-file ("lazy") configs.

Counterpart of the JAX package's ``tools/lazyconfig_train_net.py``
(capability parity with tools/lazyconfig_train_net.py:107 in the reference):
load a python config with ``LazyConfig``, apply dotted ``key=value``
overrides, save it to ``train.output_dir``, instantiate ``model`` and hand it
to the config's ``train.entry``:

    python -m vnext_tpu_torch.tools.lazyconfig_train_net \\
        --config-file vnext_tpu_torch/config/examples/idol_lazy.py [--resume] [--eval-only] \\
        train.max_iter=2 train.output_dir=out

A lazy config must define ``model`` (a ``LazyCall`` node building an
``nn.Module``) and ``train`` (a dict with ``output_dir``, ``entry``, ...).
``train.entry`` is a ``LazyCall`` node whose instance is called as
``entry(model=, cfg=, resume=, eval_only=)``; a config without one exits
saying so, as the JAX tool does. :class:`YamlTrainEntry` is such an entry: it
trains the model with the yaml recipe of a config file through the port's
plain loop (``plain_train_net.do_train``), on the card unless the recipe says
``MODEL.DEVICE cpu``. See ``vnext_tpu_torch/config/examples/idol_lazy.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Sequence

from ..config import LazyConfig, add_idol_config, get_cfg, instantiate
from ..models.layers import init_weights
from ..utils.logger import setup_logger
from . import plain_train_net, train_net


class YamlTrainEntry:
    """A lazy config's ``train.entry``: the yaml ``config_file`` with ``opts``
    (KEY VALUE pairs) is the recipe; the lazy config's ``train.output_dir``,
    ``train.max_iter`` and ``train.seed`` override its ``OUTPUT_DIR``,
    ``SOLVER.MAX_ITER`` and ``SEED``. Called with the instantiated model, it
    initializes the model's weights from the seed, moves it to the recipe's
    device, and trains it (``plain_train_net.do_train``) or, with
    ``eval_only``, evaluates it (``train_net.do_eval``)."""

    def __init__(self, config_file: str, opts: Sequence = ()):
        self.config_file = config_file
        self.opts = list(opts)

    def recipe(self, cfg):
        ycfg = get_cfg()
        add_idol_config(ycfg)
        ycfg.merge_from_file(self.config_file)
        train = cfg.train
        ycfg.merge_from_list([*self.opts, "OUTPUT_DIR", train.get("output_dir", "./output"),
                              "SOLVER.MAX_ITER", str(train.get("max_iter", ycfg.SOLVER.MAX_ITER)),
                              "SEED", str(train.get("seed", ycfg.SEED))])
        ycfg.freeze()
        return ycfg

    def __call__(self, model, cfg, resume: bool = False, eval_only: bool = False):
        ycfg = self.recipe(cfg)
        device = train_net.resolve_device(ycfg)
        init_weights(model, max(ycfg.SEED, 0))
        model = model.to(device)
        if eval_only:
            return train_net.do_eval(ycfg, model)
        return plain_train_net.do_train(ycfg, resume=resume, model=model)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("opts", nargs="*", default=[])
    args = parser.parse_args(argv)

    cfg = LazyConfig.load(args.config_file)
    if args.opts:
        LazyConfig.apply_overrides(cfg, args.opts)

    output_dir = cfg.train.get("output_dir", "./output")
    os.makedirs(output_dir, exist_ok=True)
    setup_logger(output_dir)
    LazyConfig.save(cfg, os.path.join(output_dir, "config.yaml"))

    model = instantiate(cfg.model)
    entry = cfg.train.get("entry")
    if entry is not None:
        # configs may define their own train entry: a LazyCall node receiving the model
        runner = instantiate(entry)
        return runner(model=model, cfg=cfg, resume=args.resume, eval_only=args.eval_only)
    raise SystemExit(
        "Lazy config must define train.entry (a LazyCall of a training function)."
    )


if __name__ == "__main__":
    main(sys.argv[1:])
