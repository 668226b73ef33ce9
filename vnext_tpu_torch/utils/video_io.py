"""Minimal video file IO with no native video dependencies.

The reference demo reads videos through cv2.VideoCapture and writes via
cv2.VideoWriter (demo/demo.py:98-140). This environment (and many TPU pods)
ships no cv2/ffmpeg, so the framework provides a self-contained MJPEG-AVI
codec: an AVI RIFF container whose frames are ordinary JPEGs (decoded and
encoded with PIL). MJPEG-AVI files written here play in every mainstream
player, and files from cv2.VideoWriter(*"MJPG") read back directly.

When cv2 IS importable, ``read_video`` delegates to it for non-MJPEG codecs
(mp4/h264 etc.).

The port's own copy of ``vnext_tpu.utils.video_io``: a file written by either
package reads back bit-equal in the other.
"""

from __future__ import annotations

import io
import struct
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image


def _cv2():
    try:
        import cv2

        return cv2
    except Exception:
        return None


# --------------------------------------------------------------------- read

def _riff_chunks(buf: memoryview, start: int, end: int):
    """Yield (fourcc, payload_start, payload_size) for chunks in [start, end)."""
    pos = start
    while pos + 8 <= end:
        fourcc = bytes(buf[pos : pos + 4])
        (size,) = struct.unpack("<I", buf[pos + 4 : pos + 8])
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def read_mjpeg_avi(path: str) -> Tuple[List[np.ndarray], float]:
    """Decode an MJPEG AVI. Returns (frames RGB uint8, fps)."""
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path} is not an AVI file")

    fps = 25.0
    frames: List[np.ndarray] = []

    def walk(start, end):
        nonlocal fps
        for fourcc, payload, size in _riff_chunks(buf, start, end):
            if fourcc == b"LIST":
                walk(payload + 4, payload + size)
            elif fourcc == b"avih" and size >= 4:
                (us_per_frame,) = struct.unpack("<I", buf[payload : payload + 4])
                if us_per_frame > 0:
                    fps = 1e6 / us_per_frame
            elif fourcc in (b"00dc", b"00db") and size > 0:
                with Image.open(io.BytesIO(bytes(buf[payload : payload + size]))) as im:
                    frames.append(np.asarray(im.convert("RGB")))

    walk(12, len(data))
    if not frames:
        raise ValueError(f"no MJPEG frames found in {path}")
    return frames, fps


def read_video(path: str) -> Tuple[List[np.ndarray], float]:
    """Read any video: MJPEG-AVI natively, other codecs via cv2 if present."""
    try:
        return read_mjpeg_avi(path)
    except ValueError:
        cv2 = _cv2()
        if cv2 is None:
            raise ValueError(
                f"{path}: only MJPEG-AVI is supported without cv2; "
                "re-encode with `ffmpeg -i in.mp4 -c:v mjpeg out.avi` or install cv2"
            )
        cap = cv2.VideoCapture(path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[:, :, ::-1].copy())  # BGR -> RGB
        cap.release()
        return frames, fps


# -------------------------------------------------------------------- write

class VideoWriter:
    """MJPEG-AVI writer (cv2-free). Frames are RGB uint8 [H, W, 3]."""

    def __init__(self, path: str, fps: float = 25.0, quality: int = 90):
        self.path = path
        self.fps = float(fps)
        self.quality = quality
        self._jpegs: List[bytes] = []
        self._size: Optional[Tuple[int, int]] = None

    def write(self, frame: np.ndarray) -> None:
        h, w = frame.shape[:2]
        if self._size is None:
            self._size = (w, h)
        if (w, h) != self._size:
            raise ValueError(f"all frames must share one size: {(w, h)} after {self._size}")
        bio = io.BytesIO()
        Image.fromarray(np.asarray(frame, np.uint8)).save(
            bio, format="JPEG", quality=self.quality
        )
        self._jpegs.append(bio.getvalue())

    def close(self) -> None:
        if self._size is None:
            raise ValueError("no frames written")
        w, h = self._size
        n = len(self._jpegs)
        max_bytes = max(len(j) for j in self._jpegs)

        avih = struct.pack(
            "<IIIIIIIIIIIIII",
            int(1e6 / self.fps), max_bytes * int(self.fps), 0, 0x10,  # HASINDEX
            n, 0, 1, max_bytes, w, h, 0, 0, 0, 0,
        )
        strh = (
            b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, int(self.fps),
                          0, n, max_bytes, 0xFFFFFFFF, 0)
            + struct.pack("<hhhh", 0, 0, w, h)
        )
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)

        def chunk(fourcc: bytes, payload: bytes) -> bytes:
            pad = b"\x00" if len(payload) & 1 else b""
            return fourcc + struct.pack("<I", len(payload)) + payload + pad

        def lst(kind: bytes, payload: bytes) -> bytes:
            return chunk(b"LIST", kind + payload)

        strl = lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf))
        hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl)

        movi_payload = b"".join(chunk(b"00dc", j) for j in self._jpegs)
        movi = lst(b"movi", movi_payload)

        idx, off = [], 4
        for j in self._jpegs:
            idx.append(struct.pack("<4sIII", b"00dc", 0x10, off, len(j)))
            off += 8 + len(j) + (len(j) & 1)
        idx1 = chunk(b"idx1", b"".join(idx))

        body = b"AVI " + hdrl + movi + idx1
        with open(self.path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", len(body)) + body)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._jpegs:
            self.close()
