"""One rank of tests/test_torch_distributed.py's pair of gloo processes.

    python tests/_torch_dist_worker.py IN_DIR OUT_DIR PORT RANK

Both ranks join one group through the port's ``launch`` (two machines of one
process each, ``device="cpu"``), read ``IN_DIR/inputs.pkl`` (weights, batches
and evaluators the test made) and write what they computed to
``OUT_DIR/rank{RANK}.pkl``. Imports torch and the port only.
"""

import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vnext_tpu_torch.engine.launch import launch  # noqa: E402


def _numpy(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _idol(inp):
    from vnext_tpu_torch.models.idol import IDOL

    model = IDOL(**inp["idol_kwargs"], dtype=torch.float32)
    model.load_state_dict(inp["idol_state"])
    return model


def _idol_step(inp, rank):
    """Two steps of the IDOL recipe on this rank's clip, under DDP."""
    from vnext_tpu_torch.config import add_idol_config, get_cfg
    from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
    from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, batch_to_model_inputs
    from vnext_tpu_torch.models.criterion import default_weight_dict
    from vnext_tpu_torch.solver import build as solver

    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(inp["idol_config"])
    model = _idol(inp)
    optimizer = solver.build_optimizer(cfg, model)
    state = TrainState.create(model, optimizer, solver.build_lr_scheduler(cfg, optimizer))
    step = make_train_step(model, optimizer, default_weight_dict(dec_layers=2), clip=solver.build_grad_clip(cfg))
    half = {k: v[rank:rank + 1] for k, v in inp["idol_batch"].items()}
    inputs = batch_to_model_inputs(half, PIXEL_MEAN, PIXEL_STD, "cpu")
    state, metrics = step(state, inputs)
    out = {"metrics": _floats(metrics), "instances": int(half["key_valid"].sum()),
           "after": _numpy(dict(model.named_parameters())),
           "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()}}
    state, metrics = step(state, inputs)
    out["second_total"] = float(metrics["total_loss"])
    return out


def _retinanet_step(inp, rank):
    from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
    from vnext_tpu_torch.models.layers import init_weights
    from vnext_tpu_torch.models.rcnn import DetTargets
    from vnext_tpu_torch.models.retinanet import RetinaNet

    model = RetinaNet(**inp["retina_kwargs"])
    init_weights(model, 3)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, optimizer, {"loss_cls": 1.0, "loss_box_reg": 1.0})
    images, labels, boxes, valid = (torch.from_numpy(a[rank:rank + 1]) for a in inp["retina_batch"])
    state, metrics = step(state, (images, DetTargets(labels, boxes, valid)))
    out = {"metrics": _floats(metrics), "after": _numpy(dict(model.named_parameters()))}
    state, metrics = step(state, (images, DetTargets(labels, boxes, valid)))
    out["second_total"] = float(metrics["total_loss"])
    return out


def _tensor_parallel(inp):
    """infer_tp_specs' choice, and the train forward's losses with and without apply_tp."""
    from torch.distributed.tensor import Shard

    from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, batch_to_model_inputs
    from vnext_tpu_torch.parallel import apply_tp, build_mesh, infer_tp_specs

    mesh = build_mesh((1, 2), ("data", "model"))
    plain = _idol(inp)
    specs = infer_tp_specs(plain, mesh, min_features=64)
    inputs = batch_to_model_inputs(inp["idol_batch"], PIXEL_MEAN, PIXEL_STD, "cpu")
    plain.train()
    want = _floats(plain(*inputs))
    tp = apply_tp(_idol(inp), mesh, min_features=64)
    tp.train()
    losses = tp(*inputs)
    sum(losses.values()).backward()
    sharded = [n for n, p in tp.named_parameters() if isinstance(p, torch.distributed.tensor.DTensor)]
    finite = all(bool(torch.isfinite(p.grad.full_tensor() if n in sharded else p.grad).all())
                 for n, p in tp.named_parameters() if p.grad is not None)
    return {"selected": sorted(n for n, s in specs.items() if isinstance(s, Shard)),
            "dims": {n: s.dim for n, s in specs.items() if isinstance(s, Shard)},
            "plain": want, "tp": _floats(losses), "sharded": sharded, "grads_finite": finite}


def _time_sharded(inp, rank):
    from vnext_tpu_torch.parallel import build_mesh, make_sharded_clip_inference

    model = _idol(inp).eval()
    frames, sizes = (torch.from_numpy(a) for a in inp["clip"])
    got = make_sharded_clip_inference(model, build_mesh((2,), ("data",)))(frames, sizes)
    out = {"sharded": _numpy(got)}
    if rank == 0:
        with torch.no_grad():
            out["whole"] = _numpy(model.inference(frames, sizes))
    return out


def _sync_bn(inp, rank):
    from vnext_tpu_torch.models.layers import SyncBatchNorm

    bn = SyncBatchNorm(3)
    bn.load_state_dict(inp["bn_state"])
    x = torch.from_numpy(inp["bn_x"][2 * rank:2 * rank + 2]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(inp["bn_probe"][2 * rank:2 * rank + 2])).sum().backward()
    return {"y": y.detach().numpy(), "grad": x.grad.numpy(), "mean": bn.bn.mean.numpy(), "var": bn.bn.var.numpy()}


def _evaluators(inp, rank):
    out = {}
    for name, evaluator, records, outputs in inp["evaluators"]:
        evaluator.reset()
        evaluator.process(records[rank::2], outputs[rank::2])
        out[name] = evaluator.evaluate()
    return out


def main(in_dir, out_dir):
    from vnext_tpu_torch.parallel import local_device_count, process_allgather, process_count, process_index
    from vnext_tpu_torch.utils.logger import setup_logger

    torch.set_num_threads(2)
    rank = process_index()
    log = setup_logger(os.path.join(out_dir, "logs"), name="vnext_tpu_torch.dist_test", process_rank=rank)
    log.info("rank %d of %d", rank, process_count())
    with open(os.path.join(in_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"world": (rank, process_count(), local_device_count()), "gathered": process_allgather({"rank": rank}),
           "idol": _idol_step(inp, rank), "retinanet": _retinanet_step(inp, rank), "tp": _tensor_parallel(inp),
           "time": _time_sharded(inp, rank), "bn": _sync_bn(inp, rank), "eval": _evaluators(inp, rank)}
    for h in log.handlers:
        h.flush()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    in_dir, out_dir, port, rank = sys.argv[1:5]
    launch(main, num_gpus_per_machine=1, num_machines=2, machine_rank=int(rank),
           dist_url=f"tcp://127.0.0.1:{port}", args=(in_dir, out_dir), device="cpu")
