"""Video inference + visualization demo on the card.

Counterpart of the JAX package's ``demo/demo.py`` (reference: demo/demo.py +
demo/predictor.py VisualizationDemo), with the same flags: run IDOL, SeqFormer
or MinVIS on a directory of frames (or a glob), a video file or a webcam, and
write visualized frames with per-track colors.

    python -m vnext_tpu_torch.tools.demo --config-file configs/idol/ytvis19_r50.yaml \\
        --input frames_dir --output vis_dir [MODEL.WEIGHTS model.pth]
    python -m vnext_tpu_torch.tools.demo --config-file configs/idol/ytvis19_r50.yaml \\
        --video-input clip.avi --video-output vis.avi        # MJPEG-AVI natively, other codecs with cv2
    python -m vnext_tpu_torch.tools.demo --config-file configs/minvis/ovis_r50.yaml \\
        --model-type minvis --webcam --webcam-max-frames 100 --output vis_dir   # needs cv2

The model is what ``build_model`` builds from the config, with seeded weights,
then ``MODEL.WEIGHTS`` (a port checkpoint, a reference ``.pth`` or a ``.pkl``)
loaded if set. It runs on the card unless the config says ``MODEL.DEVICE
cpu``; with no CUDA device visible it raises. Visualization and encoding run in
an ``AsyncPredictor`` worker, overlapping the writes.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np
from PIL import Image

from ..checkpoint.checkpointer import load_weights
from ..config import add_idol_config, add_maskformer_config, add_seqformer_config, get_cfg
from ..engine.minvis_inference import MinVISVideoInference
from ..engine.predictor import AsyncPredictor
from ..engine.seqformer_inference import SeqFormerVideoInference
from ..engine.vis_inference import IDOLVideoInference
from ..models import build_model
from ..utils.video_io import VideoWriter, read_video
from ..utils.visualizer import VideoVisualizer
from .train_net import resolve_device

# --model-type -> the config's keys and the meta-architectures it runs
MODEL_TYPES = {"idol": (add_idol_config, ("IDOL",)), "seqformer": (add_seqformer_config, ("SeqFormer",)),
               "minvis": (add_maskformer_config, ("MaskFormer", "VideoMaskFormer_frame"))}


def draw_video_frame(viz, frame, out, keep, t):
    """Frame ``t`` with the kept instances' masks, labels and scores drawn."""
    tids, masks, labels, scores = [], [], [], []
    for i in keep:
        m = out["pred_masks"][i][t]
        if m is None:
            continue
        tids.append(i)
        masks.append(m)
        labels.append(out["pred_labels"][i])
        scores.append(out["pred_scores"][i])
    if masks:
        frame = viz.draw_frame(frame, tids, labels=np.asarray(labels), scores=np.asarray(scores),
                               masks=np.stack(masks))
    return frame


def _run_webcam(args, runner, cam_buffer, chunk):
    """Live camera loop (reference demo/demo.py:98 --webcam): capture a clip,
    run the video model on it, show/write annotated frames, repeat until
    q/ESC or --webcam-max-frames. Track identities are per-clip (the runner
    associates within a clip); the visualizer keeps colors stable by id."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("--webcam reads the camera through cv2 (opencv-python), which is not "
                           "installed; use --input or --video-input") from e

    cap = cv2.VideoCapture(args.webcam_device)
    if not cap.isOpened():
        raise SystemExit(f"cannot open camera device {args.webcam_device}")
    viz = VideoVisualizer()
    writer = None
    processed = 0
    display = bool(os.environ.get("DISPLAY"))
    try:
        stop = False
        while not stop:
            paths = []
            for _ in range(chunk):
                ok, bgr = cap.read()
                if not ok:
                    stop = True
                    break
                name = f"cam_{processed + len(paths):08d}"
                cam_buffer[name] = np.ascontiguousarray(bgr[:, :, ::-1])
                paths.append(name)
                if args.webcam_max_frames and processed + len(paths) >= args.webcam_max_frames:
                    stop = True
                    break
            if not paths:
                break
            h, w = cam_buffer[paths[0]].shape[:2]
            out = runner({"file_names": paths, "height": h, "width": w, "length": len(paths), "video_id": 0})
            keep = [i for i, s in enumerate(out["pred_scores"]) if s >= args.confidence_threshold]
            for t, p in enumerate(paths):
                frame = draw_video_frame(viz, np.ascontiguousarray(cam_buffer[p]), out, keep, t)
                if args.video_output:
                    if writer is None:
                        writer = VideoWriter(args.video_output, fps=25.0)
                    writer.write(frame)
                if args.output:
                    os.makedirs(args.output, exist_ok=True)
                    Image.fromarray(frame).save(os.path.join(args.output, f"{p}.png"))
                if display:
                    cv2.imshow("vnext_tpu_torch demo", frame[:, :, ::-1])
                    if cv2.waitKey(1) & 0xFF in (ord("q"), 27):
                        stop = True
                processed += 1
            for p in paths:
                cam_buffer.pop(p, None)
    finally:
        cap.release()
        if writer is not None:
            writer.close()
        if display:
            cv2.destroyAllWindows()
    print(f"Processed {processed} webcam frames")
    return {"frames": processed}


def build_runner(cfg, model_type: str, device, image_loader):
    """The model (``build_model``, then ``MODEL.WEIGHTS``) and its runner, wired
    as the JAX demo wires them."""
    if cfg.MODEL.META_ARCHITECTURE not in MODEL_TYPES[model_type][1]:
        raise ValueError(f"--model-type {model_type} runs {' or '.join(MODEL_TYPES[model_type][1])}, and the "
                         f"config's MODEL.META_ARCHITECTURE is {cfg.MODEL.META_ARCHITECTURE!r}")
    model = build_model(cfg, device=device)
    if cfg.MODEL.WEIGHTS:
        load_weights(cfg.MODEL.WEIGHTS, model)
    common = dict(
        test_short_edge=cfg.INPUT.MIN_SIZE_TEST,
        test_max_size=cfg.INPUT.MAX_SIZE_TEST,
        target_size=tuple(cfg.TPU.TEST_IMAGE_SIZE),
        pixel_mean=cfg.MODEL.PIXEL_MEAN,
        pixel_std=cfg.MODEL.PIXEL_STD,
        image_loader=image_loader,
    )
    if model_type == "idol":
        return IDOLVideoInference(model, batch_infer_len=cfg.MODEL.IDOL.BATCH_INFER_LEN, **common)
    if model_type == "seqformer":
        s = cfg.MODEL.SeqFormer
        return SeqFormerVideoInference(model, clip_matching=s.CLIP_MATCHING, clip_length=s.CLIP_LENGTH,
                                       clip_stride=s.CLIP_STRIDE, **common)
    return MinVISVideoInference(model, **common)


def main(argv=None):
    """Run the demo on ``argv`` (default ``sys.argv[1:]``). Returns the
    runner's output (``output``), the frames written (``frames``), the
    inference's host seconds (``inference_s``) and the visualization and
    writing's host milliseconds per frame (``visualize_ms_per_frame``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--model-type", default="idol", choices=sorted(MODEL_TYPES))
    parser.add_argument("--input", help="directory of frames or glob")
    parser.add_argument("--video-input", help="video file (MJPEG-AVI without cv2)")
    parser.add_argument("--webcam", action="store_true",
                        help="live camera input (reference demo.py --webcam); "
                             "processes rolling clips and shows/writes results")
    parser.add_argument("--webcam-device", type=int, default=0)
    parser.add_argument("--webcam-max-frames", type=int, default=0,
                        help="stop after this many frames (0 = until q/ESC)")
    parser.add_argument("--output", help="output directory for visualized frames")
    parser.add_argument("--video-output", help="output video file (MJPEG-AVI)")
    parser.add_argument("--confidence-threshold", type=float, default=0.3)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)

    cfg = get_cfg()
    MODEL_TYPES[args.model_type][0](cfg)
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    if not (args.input or args.video_input or args.webcam):
        raise SystemExit("one of --input / --video-input / --webcam is required")
    if not (args.output or args.video_output or args.webcam):
        raise SystemExit("one of --output / --video-output is required")
    device = resolve_device(cfg)

    fps = 25.0
    cam_buffer = {}
    if args.webcam:
        # frames arrive live; the runner's image_loader indexes the capture
        # buffer filled by _run_webcam below
        frame_paths = []
        load_frame = lambda p: cam_buffer[p]                                   # noqa: E731
    elif args.video_input:
        video_frames, fps = read_video(args.video_input)
        frame_paths = [f"frame_{t:06d}.jpg" for t in range(len(video_frames))]
        load_frame = lambda p: video_frames[int(p[6:12])]                      # noqa: E731
    else:
        frame_paths = sorted(
            glob.glob(os.path.join(args.input, "*")) if os.path.isdir(args.input) else glob.glob(args.input)
        )
        if not frame_paths:
            raise SystemExit(f"No frames found at {args.input}")
        load_frame = lambda p: np.asarray(Image.open(p).convert("RGB"))        # noqa: E731

    runner = build_runner(cfg, args.model_type, device, load_frame)
    if args.webcam:
        chunk = (cfg.MODEL.IDOL.BATCH_INFER_LEN if args.model_type == "idol"
                 else cfg.MODEL.SeqFormer.CLIP_LENGTH if args.model_type == "seqformer" else 8)
        return _run_webcam(args, runner, cam_buffer, max(int(chunk), 2))

    first = load_frame(frame_paths[0])
    record = {"file_names": frame_paths, "height": first.shape[0], "width": first.shape[1],
              "length": len(frame_paths), "video_id": 0}
    t0 = time.perf_counter()
    out = runner(record)   # host numpy: the card has finished
    inference_s = time.perf_counter() - t0

    viz = VideoVisualizer()
    keep = [i for i, s in enumerate(out["pred_scores"]) if s >= args.confidence_threshold]

    def visualize(item):
        t, path = item
        return draw_video_frame(viz, np.ascontiguousarray(load_frame(path)), out, keep, t)

    # visualization overlaps the writes through the async worker (the reference
    # demo's AsyncPredictor)
    t0 = time.perf_counter()
    worker = AsyncPredictor(visualize, queue_size=8)
    writer = VideoWriter(args.video_output, fps=fps) if args.video_output else None
    if args.output:
        os.makedirs(args.output, exist_ok=True)
    n_in_flight = 0
    results_written = 0
    try:
        for t, path in enumerate(frame_paths):
            worker.put((t, path))
            n_in_flight += 1
            while n_in_flight > 4 or (t == len(frame_paths) - 1 and n_in_flight):
                frame = worker.get()
                if writer is not None:
                    writer.write(frame)
                if args.output:
                    Image.fromarray(frame).save(
                        os.path.join(args.output, os.path.basename(frame_paths[results_written])))
                results_written += 1
                n_in_flight -= 1
    finally:
        worker.shutdown()
    if writer is not None:
        writer.close()
        print(f"Wrote visualized video to {args.video_output}")
    if args.output:
        print(f"Wrote {results_written} visualized frames to {args.output}")
    visualize_ms = (time.perf_counter() - t0) * 1e3 / max(results_written, 1)
    return {"output": out, "frames": results_written, "inference_s": inference_s,
            "visualize_ms_per_frame": visualize_ms}


if __name__ == "__main__":
    main(sys.argv[1:])
