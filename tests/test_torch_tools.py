"""The port's user-facing utilities against the JAX package's, on the CPU:
the registry and ``build_model``, ``seed_all_rng``, the MJPEG-AVI codec, the
visualizer, ``AsyncPredictor``, ``retry_if_oom``, ``@configurable`` /
``auto_scale_workers`` / config compat, ``LazyConfig`` and the model zoo.
Nothing here compiles a JAX program; every comparison is exact."""

import datetime
import fractions
import os
import random
import socket
import time

import numpy as np
import pytest
import torch

from vnext_tpu.config import get_cfg as jax_get_cfg
from vnext_tpu.utils import visualizer as jax_vis
from vnext_tpu_torch.utils import visualizer as vis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIS_QUICK = ("idol_instant_test.yaml", "seqformer_instant_test.yaml", "minvis_instant_test.yaml")


# ---------------------------------------------------------------- registry, build_model
def _exercise_registry(registry_cls):
    reg = registry_cls("THING")

    @reg.register()
    class A:
        pass

    def b():
        return 1

    reg.register(b)
    out = [sorted(reg.keys()), "A" in reg, "C" in reg, [k for k, _ in reg], repr(reg), reg.get("b") is b]
    for bad in (lambda: reg.register(b), lambda: reg.get("C")):
        with pytest.raises(KeyError) as e:
            bad()
        out.append(str(e.value))
    return out


def test_registry_behaves_as_jax():
    from vnext_tpu.utils.registry import Registry as JaxRegistry
    from vnext_tpu_torch.utils.registry import Registry

    assert _exercise_registry(Registry) == _exercise_registry(JaxRegistry)


def _port_cfg(path):
    from vnext_tpu_torch.config import add_idol_config, add_maskformer_config, add_seqformer_config, get_cfg

    cfg = get_cfg()
    if "minvis" in path:
        add_maskformer_config(cfg)
    else:
        add_idol_config(cfg)
        add_seqformer_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, path))
    return cfg


def _jax_cfg(path):
    from vnext_tpu.config import add_idol_config, add_maskformer_config, add_seqformer_config

    cfg = jax_get_cfg()
    if "minvis" in path:
        add_maskformer_config(cfg)
    else:
        add_idol_config(cfg)
        add_seqformer_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, path))
    return cfg


@pytest.mark.parametrize("name", VIS_QUICK)
def test_build_model_builds_jax_architecture(name):
    """The quick-schedule yaml's meta-architecture with the JAX model's
    constructor values (built on the meta device: shapes only)."""
    from vnext_tpu.models import build_model as jax_build_model
    from vnext_tpu_torch.models import build_model

    path = f"configs/quick_schedules/{name}"
    jmodel = jax_build_model(_jax_cfg(path))
    model = build_model(_port_cfg(path), device="meta")
    assert type(model).__name__ == type(jmodel).__name__
    assert all(p.is_meta for p in model.parameters())
    for field in ("num_classes", "hidden_dim", "num_queries", "dec_layers"):
        want = getattr(jmodel, field, None)
        if want is not None and hasattr(model, field):
            assert getattr(model, field) == want, field


def test_build_model_refuses_detectron2_and_unknown_architectures():
    from vnext_tpu_torch.models import META_ARCH_REGISTRY, build_model

    cfg = _port_cfg("configs/quick_schedules/idol_instant_test.yaml")
    for name, err, match in (("PanopticFPN", NotImplementedError, "item 11d"), ("SemanticSegmentor",
                             NotImplementedError, "item 11d"), ("NoSuchArch", KeyError, "No object named")):
        cfg.MODEL.META_ARCHITECTURE = name
        with pytest.raises(err, match=match):
            build_model(cfg, device="meta")
    # FCOS and RetinaNet are ported since, and build
    for name in ("FCOS", "RetinaNet"):
        cfg.MODEL.META_ARCHITECTURE = name
        assert type(build_model(cfg, device="meta")).__name__ == name
    assert sorted(META_ARCH_REGISTRY.keys()) == ["FCOS", "GeneralizedRCNN", "IDOL", "MaskFormer", "ProposalNetwork",
                                                 "RetinaNet", "SeqFormer"]
    cfg.MODEL.META_ARCHITECTURE = "VideoMaskFormer_frame"
    assert type(build_model(_port_cfg("configs/quick_schedules/minvis_instant_test.yaml"), device="meta")
                ).__name__ == "MaskFormer"


def test_build_model_raises_for_the_card_without_one():
    from vnext_tpu_torch.models import build_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(_port_cfg("configs/quick_schedules/idol_instant_test.yaml"))


# ---------------------------------------------------------------- env
def test_seed_all_rng_draws_as_jax(monkeypatch):
    from vnext_tpu.utils.env import seed_all_rng as jax_seed
    from vnext_tpu_torch.utils.env import collect_env_info, seed_all_rng

    monkeypatch.setenv("PYTHONHASHSEED", "0")

    def draws(seed_fn, seed):
        s = seed_fn(seed)
        return s, random.random(), random.randint(0, 10 ** 9), np.random.rand(4).tolist(), os.environ["PYTHONHASHSEED"]

    for seed in (0, 7, 2 ** 31 - 1, 2 ** 33 + 5):
        assert draws(seed_all_rng, seed) == draws(jax_seed, seed)
    torch_state = torch.random.get_rng_state()
    seed = seed_all_rng(None)
    assert 0 <= seed < 2 ** 31 and os.environ["PYTHONHASHSEED"] == str(seed)
    assert torch.equal(torch.random.get_rng_state(), torch_state)     # torch's global generator untouched
    info = collect_env_info()
    assert "torch:" in info and "nvcc:" in info and "jax" not in info


# ---------------------------------------------------------------- video I/O
def test_avi_written_by_either_package_reads_back_in_the_other(tmp_path):
    from vnext_tpu.utils import video_io as jax_io
    from vnext_tpu_torch.utils import video_io

    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 255, (36, 50, 3), np.uint8) for _ in range(5)]
    paths = {}
    for name, mod in (("jax", jax_io), ("port", video_io)):
        paths[name] = str(tmp_path / f"{name}.avi")
        with mod.VideoWriter(paths[name], fps=12.5) as vw:
            for fr in frames:
                vw.write(fr)
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()
    for writer in ("jax", "port"):
        jf, jfps = jax_io.read_video(paths[writer])
        pf, pfps = video_io.read_video(paths[writer])
        assert jfps == pfps == 12.5 and len(pf) == 5
        assert all(np.array_equal(a, b) for a, b in zip(jf, pf))
    with pytest.raises(ValueError, match="share one size"):
        video_io.VideoWriter(str(tmp_path / "x.avi")).write(frames[0]) or None
        vw = video_io.VideoWriter(str(tmp_path / "x.avi"))
        vw.write(frames[0])
        vw.write(frames[0][:10])


# ---------------------------------------------------------------- visualizer
def _scene(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (48, 64, 3), np.uint8)
    masks = np.zeros((3, 48, 64), bool)
    masks[0, 5:20, 5:30] = True
    masks[1, 25:45, 30:60] = True
    masks[2, 10:40, 40:50] = True
    boxes = np.asarray([[5, 5, 30, 20], [30, 25, 60, 45], [40, 10, 50, 40]], np.float32)
    return img, masks, boxes, np.asarray([0, 2, 1]), np.asarray([0.9, 0.55, 0.31])


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["image", "segmentation", "image_bw"])
def test_visualizer_draws_jax_pixels(mode):
    img, masks, boxes, labels, scores = _scene(mode)
    names = ["cat", "dog", "bird"]
    outs = []
    for mod in (vis, jax_vis):
        v = mod.Visualizer(img, names, color_mode=mode)
        a = v.draw_instances(boxes=boxes, labels=labels, scores=scores, masks=masks, track_ids=[4, 9, 2])
        b = mod.Visualizer(img, names).draw_rotated_instances(
            np.asarray([[30, 20, 20, 10, 30.0], [10, 30, 8, 16, -45.0]]), labels=labels[:2], scores=scores[:2])
        sem = np.full((48, 64), 255, np.int64)
        sem[:20] = 1
        sem[30:] = 3
        c = mod.Visualizer(img).draw_sem_seg(sem, stuff_names=["a", "b", "c", "d"])
        kp = np.asarray([[[5, 5, 1.0], [20, 30, 0.9], [40, 10, 0.0]], [[50, 40, 1.0], [30, 30, 0.5], [1, 1, 1]]])
        d = mod.Visualizer(img).draw_keypoints(kp, connectivity=[(0, 1), (1, 2)])
        pan = np.zeros((48, 64), np.int64)
        pan[:24, :32], pan[24:, 32:] = 1, 2
        e = mod.Visualizer(img, names).draw_panoptic_seg(
            pan, [{"id": 1, "isthing": True, "category_id": 1}, {"id": 2, "isthing": False, "category_id": 0}],
            stuff_names=["sky"])
        vv = mod.VideoVisualizer(names)
        f = [vv.draw_frame(img, [7, 3], labels=labels[:2], scores=scores[:2], masks=masks[:2]),
             vv.draw_frame(img, [3, 11], boxes=boxes[1:], labels=labels[1:], masks=masks[1:])]
        outs.append([a, b, c, d, e, *f])
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_draw_dataset_dict_draws_jax_pixels():
    from vnext_tpu.evaluation.rle import rle_encode

    img, masks, _, _, _ = _scene(5)
    record = {"height": 48, "width": 64, "sem_seg": np.where(masks[0], 2, 255), "annotations": [
        {"bbox": [5, 5, 25, 15], "bbox_mode": 1, "category_id": 0,
         "segmentation": [[5, 5, 30, 5, 30, 20, 5, 20]]},
        {"bbox": [30, 25, 60, 45], "bbox_mode": 0, "category_id": 2, "segmentation": rle_encode(masks[1]),
         "keypoints": [35, 30, 2, 50, 40, 1, 0, 0, 0]},
    ]}
    got = vis.Visualizer(img, ["a", "b", "c"]).draw_dataset_dict(record)
    want = jax_vis.Visualizer(img, ["a", "b", "c"]).draw_dataset_dict(record)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------- predictor, memory
def test_async_predictor_order_and_errors():
    from vnext_tpu_torch.engine.predictor import AsyncPredictor, DefaultPredictor

    def slow_sq(x):
        time.sleep(0.01 * max(3 - x, 0))  # earlier items take longer
        if x == 99:
            raise ValueError("boom")
        return x * x

    ap = AsyncPredictor(slow_sq)
    for i in range(3):
        ap.put(i)
    assert len(ap) == 3
    assert [ap.get() for _ in range(3)] == [0, 1, 4]  # order preserved
    ap.put(99)
    ap.put(2)
    with pytest.raises(ValueError, match="boom"):
        ap.get()
    assert ap.get() == 4
    ap.shutdown()
    pred = DefaultPredictor(lambda a, b: a * b, lambda x: (x, 2), lambda out, x: (out, x))
    assert pred(5) == (10, 5)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_retry_if_oom_splits_as_jax(kind):
    from vnext_tpu.utils.memory import retry_if_oom as jax_retry
    from vnext_tpu_torch.utils.memory import retry_if_oom

    calls = {"port": [], "jax": []}

    def make(key, error):
        def fn(x):
            calls[key].append(x.shape[0])
            if x.shape[0] > 2:
                raise error
            return x * 2
        return fn

    x = np.arange(8.0) if kind == "numpy" else torch.arange(8.0)
    out = retry_if_oom(make("port", torch.cuda.OutOfMemoryError("CUDA error: out of memory")))(x)
    want = jax_retry(make("jax", RuntimeError("RESOURCE EXHAUSTED: out of memory")))(np.arange(8.0))
    assert isinstance(out, np.ndarray if kind == "numpy" else torch.Tensor)
    np.testing.assert_array_equal(np.asarray(out), want)
    assert calls["port"] == calls["jax"] == [8, 4, 2, 2, 2, 2]

    def bad(x):
        raise ValueError("not oom")

    with pytest.raises(ValueError):
        retry_if_oom(bad)(x)

    def always(x):
        raise torch.cuda.OutOfMemoryError("out of memory")

    with pytest.raises(RuntimeError, match="still OOM"):
        retry_if_oom(always)(x)


# ---------------------------------------------------------------- config
def _configurable_results(pkg):
    import importlib

    config = importlib.import_module(f"{pkg}.config")

    class Thing:
        @config.configurable
        def __init__(self, a, b=1):
            self.a, self.b = a, b

        @classmethod
        def from_config(cls, cfg, extra=0):
            return {"a": cfg.MODEL.MASK_ON, "b": 7 + extra}

    @config.configurable(from_config=lambda cfg, k=1: {"a": 42 * k})
    def build(a):
        return a

    cfg = config.get_cfg()
    t, t2, t3 = Thing(cfg), Thing(a=5, b=2), Thing(cfg, extra=3)
    out = [(t.a, t.b), (t2.a, t2.b), (t3.a, t3.b), build(cfg), build(a=3), build(cfg=cfg, k=2)]

    cfg.SOLVER.REFERENCE_WORLD_SIZE = 8
    cfg.SOLVER.IMS_PER_BATCH = 16
    cfg.SOLVER.BASE_LR = 0.1
    cfg.SOLVER.MAX_ITER = 1000
    cfg.SOLVER.STEPS = (600, 800)
    cfg.SOLVER.WARMUP_ITERS = 100
    cfg.freeze()
    scaled = config.auto_scale_workers(cfg, 16)
    out += [scaled.dump(), scaled.is_frozen(), cfg.SOLVER.IMS_PER_BATCH, config.auto_scale_workers(cfg, 8) is cfg]
    cfg.defrost()
    cfg.SOLVER.REFERENCE_WORLD_SIZE = 0
    out.append(config.auto_scale_workers(cfg, 4) is cfg)
    return out


def test_configurable_and_auto_scale_workers_as_jax():
    got, want = _configurable_results("vnext_tpu_torch"), _configurable_results("vnext_tpu")
    assert got == want
    assert got[0][1] == 7 and got[3] == 42 and "IMS_PER_BATCH: 32" in got[6]


def test_config_compat_upgrade_downgrade_as_jax():
    from vnext_tpu.config.cfgnode import CfgNode as JaxCfgNode
    from vnext_tpu.config.compat import downgrade_config as jax_down, upgrade_config as jax_up
    from vnext_tpu_torch.config.cfgnode import CfgNode
    from vnext_tpu_torch.config.compat import downgrade_config, upgrade_config

    def run(node_cls, up, down):
        old = node_cls()
        old.VERSION = 1
        old.MODEL = node_cls()
        old.MODEL.TPU_MESH_SHAPE = (8,)
        old.MODEL.TPU_COMPUTE_DTYPE = "bfloat16"
        old.MODEL.WEIGHTS = "x.pth"
        new = up(old)
        back = down(new, 1)
        return new.dump(), back.dump(), old.dump()

    got = run(CfgNode, upgrade_config, downgrade_config)
    assert got == run(JaxCfgNode, jax_up, jax_down)
    assert "MESH_SHAPE" in got[0] and "TPU_MESH_SHAPE" not in got[0] and "TPU_MESH_SHAPE" in got[1]
    with pytest.raises(ValueError):
        upgrade_config(CfgNode({"VERSION": 3}), 2)


LAZY_CONFIG = '''
import fractions
model = {"_target_": "fractions.Fraction", "numerator": 3, "denominator": 4}
optimizer = dict(lr=0.1, betas=[0.9, 0.999], nested={"_target_": "datetime.timedelta", "days": 1, "seconds": 5})
train = {"max_iter": 10, "output_dir": "./out", "tags": ("a", "b"), "init": None}
_private = 5
'''


def test_lazy_config_as_jax(tmp_path):
    from vnext_tpu.config import LazyConfig as JaxLazyConfig, instantiate as jax_instantiate
    from vnext_tpu.config.lazy import LazyCall as JaxLazyCall
    from vnext_tpu_torch.config import LazyCall, LazyConfig, instantiate
    from vnext_tpu_torch.config.lazy import locate

    path = tmp_path / "cfg.py"
    path.write_text(LAZY_CONFIG)
    overrides = ["train.max_iter=20", "optimizer.lr=0.5", "train.output_dir=/x/y", "optimizer.betas=[0.8, 0.9]"]
    results = []
    for lc, inst in ((LazyConfig, instantiate), (JaxLazyConfig, jax_instantiate)):
        cfg = lc.load(str(path))
        loaded = lc.to_py(cfg)
        lc.apply_overrides(cfg, overrides)
        out = tmp_path / f"{len(results)}.yaml"
        lc.save(cfg, str(out))
        results.append((loaded, lc.to_py(cfg), out.read_text(), inst(cfg.model), inst(cfg.optimizer),
                        lc.load(str(path), keys="train.max_iter")))
    assert results[0] == results[1]
    assert results[0][3] == fractions.Fraction(3, 4)
    assert results[0][4]["nested"] == datetime.timedelta(days=1, seconds=5)
    assert LazyCall(fractions.Fraction)(numerator=1) == JaxLazyCall(fractions.Fraction)(numerator=1)
    assert locate("vnext_tpu_torch.models.idol.IDOL").__module__ == "vnext_tpu_torch.models.idol"
    with pytest.raises(ValueError, match="key=value"):
        LazyConfig.apply_overrides(LazyConfig.load(str(path)), ["no_equals"])


def test_lazy_example_loads_and_names_the_port():
    from vnext_tpu_torch.config import LazyConfig
    from vnext_tpu_torch.models.idol import IDOL
    from vnext_tpu_torch.tools.lazyconfig_train_net import YamlTrainEntry

    cfg = LazyConfig.load(os.path.join(REPO, "vnext_tpu_torch", "config", "examples", "idol_lazy.py"))
    assert cfg.model["_target_"] is IDOL and cfg.train.entry["_target_"] is YamlTrainEntry
    assert os.path.exists(cfg.train.entry["config_file"])
    assert "vnext_tpu_torch.models.idol.IDOL" in LazyConfig.to_py(cfg)


# ---------------------------------------------------------------- model zoo
def test_model_zoo_configs_and_urls_equal_jax():
    from vnext_tpu import model_zoo as jax_zoo
    from vnext_tpu_torch import model_zoo

    assert model_zoo.list_configs() == jax_zoo.list_configs()
    for p in model_zoo.list_configs():
        assert model_zoo.get_checkpoint_url(p) == jax_zoo.get_checkpoint_url(p)
        assert model_zoo.get_config(p).dump() == jax_zoo.get_config(p).dump(), p
        assert model_zoo.get_config_file(p) == jax_zoo.get_config_file(p)
    with pytest.raises(RuntimeError, match="not available"):
        model_zoo.get_config_file("idol/nothing.yaml")


def test_model_zoo_builds_every_entry_on_meta():
    from vnext_tpu.models import build_model as jax_build_model
    from vnext_tpu import model_zoo as jax_zoo
    from vnext_tpu_torch import model_zoo

    for p in model_zoo.list_configs():
        model, cfg = model_zoo.get(p, init=False)
        assert type(model).__name__ == type(jax_build_model(jax_zoo.get_config(p))).__name__, p
        assert all(t.is_meta for t in model.parameters())
        assert cfg.MODEL.META_ARCHITECTURE in ("IDOL", "MaskFormer")


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the model zoo opened a socket")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


def test_model_zoo_loads_a_cached_checkpoint_and_never_downloads(tmp_path, monkeypatch, no_network):
    from vnext_tpu_torch import model_zoo
    from vnext_tpu_torch.checkpoint.torch_import import to_reference_names

    p = "idol/ytvis19_r50.yaml"
    monkeypatch.setenv("VNEXT_WEIGHTS", str(tmp_path))
    assert model_zoo.resolve_checkpoint(p) is None
    with pytest.raises(FileNotFoundError, match="YTVIS19_R50_502AP.pth") as e:
        model_zoo.get(p, trained=True, device="cpu")
    assert model_zoo.get_checkpoint_url(p) in str(e.value)
    assert model_zoo.get_config(p, trained=True).MODEL.WEIGHTS == model_zoo.get_checkpoint_url(p)

    gen = torch.Generator().manual_seed(3)
    tiny = {"query_embed": torch.randn(300, 512, generator=gen),
            "class_embed_5.bias": torch.randn(40, generator=gen)}
    name = os.path.basename(model_zoo.get_checkpoint_url(p))
    torch.save({"model": to_reference_names(tiny, "idol")}, tmp_path / name)
    assert model_zoo.resolve_checkpoint(p) == str(tmp_path / name)
    model, cfg = model_zoo.get(p, trained=True, device="cpu")
    assert cfg.MODEL.WEIGHTS == str(tmp_path / name)
    assert torch.equal(model.query_embed.detach(), tiny["query_embed"])
    assert torch.equal(model.class_embed_5.bias.detach(), tiny["class_embed_5.bias"])
