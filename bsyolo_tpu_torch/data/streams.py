"""Threaded multi-stream video ingestion (counterpart of ``bsyolo_tpu/data/streams.py``
``LoadStreams``; reference data/loaders.py).

One daemon thread per source keeps only the LATEST decoded frame (or, with
``buffer=True``, every frame), so slow inference never builds unbounded decode
backlogs. Sources: webcam indices, video files, rtsp/http URLs, or a
``.streams`` text file listing one source per line. Decoding is OpenCV's
``VideoCapture``, imported when a reader is built (without OpenCV:
ImportError naming the ROADMAP item). ``close()`` stops the readers and joins
them with a timeout.

    streams = LoadStreams(["0", "rtsp://cam/1"])   # or LoadStreams("list.streams")
    try:
        for frames, paths in streams:               # lock-step latest frames
            results = model.predict(frames)
    finally:
        streams.close()

The JAX package's ``LoadScreenshots`` (needs ``mss``) is not ported: here it
raises, naming ROADMAP queue 1, item 26.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import List, Sequence, Union

from bsyolo_tpu_torch.utils import CV2_VIDEO, import_cv2

JOIN_TIMEOUT_S = 1.0  # per reader thread, in close()


class LoadStreams:
    """Latest-frame threaded reader over N video sources."""

    def __init__(self, sources: Union[str, Sequence], vid_stride: int = 1, buffer: bool = False):
        cv2 = import_cv2("reading video streams", CV2_VIDEO)
        if isinstance(sources, (str, Path)) and str(sources).endswith(".streams"):
            sources = [s.strip() for s in Path(sources).read_text().splitlines() if s.strip()]
        elif isinstance(sources, (str, Path, int)):
            sources = [sources]
        self.sources = [str(s) for s in sources]
        self.vid_stride = vid_stride
        self.buffer = buffer  # True: keep every frame; False: latest only
        self.running = True
        self.caps = []
        self.frames: List[list] = [[] for _ in self.sources]
        self._last: List = [None] * len(self.sources)
        self.locks = [threading.Lock() for _ in self.sources]
        self.alive = [True] * len(self.sources)  # per-stream liveness
        self.threads = []
        self.fps = []
        try:
            for i, s in enumerate(self.sources):
                cap = cv2.VideoCapture(int(s) if s.isnumeric() else s)
                self.caps.append(cap)
                if not cap.isOpened():
                    raise ConnectionError(f"cannot open stream {s}")
                self.fps.append(max(cap.get(cv2.CAP_PROP_FPS) or 30.0, 1.0))
                ok, frame = cap.read()
                if not ok:
                    raise ConnectionError(f"cannot read from stream {s}")
                self.frames[i].append(frame)
                self._last[i] = frame
                t = threading.Thread(target=self._reader, args=(i,), daemon=True)
                t.start()
                self.threads.append(t)
        except BaseException:
            self.close()  # the readers of the sources opened so far
            raise

    def _reader(self, i: int):
        n = 0
        cap = self.caps[i]
        while self.running and cap.isOpened():
            ok = cap.grab()
            if not ok:
                break
            n += 1
            if n % self.vid_stride:
                continue
            ok, frame = cap.retrieve()
            if not ok:
                break
            with self.locks[i]:
                if self.buffer:
                    self.frames[i].append(frame)
                else:
                    self.frames[i] = [frame]
        # only THIS stream ended; the others keep running (a dropped camera
        # must not kill the healthy feeds)
        self.alive[i] = False

    def __iter__(self):
        return self

    def __next__(self):
        if not self.running or not (any(self.alive) or any(self.frames)):
            raise StopIteration
        out = []
        for i in range(len(self.sources)):
            frame = None
            for _ in range(200):  # ~2 s grace for a fresh frame
                with self.locks[i]:
                    if self.frames[i]:
                        frame = self.frames[i].pop(0) if self.buffer else self.frames[i][-1]
                        if not self.buffer:
                            self.frames[i] = []
                        self._last[i] = frame
                        break
                if not (self.running and self.alive[i]):
                    break
                time.sleep(0.01)
            if frame is None:
                # dead/stalled stream: repeat its last frame so the healthy
                # streams keep flowing; stop only when every stream is done
                frame = self._last[i]
                if frame is None:
                    raise StopIteration
            out.append(frame)
        if not any(self.alive) and not any(self.frames):
            self.running = False  # drained: next call stops
        return out, list(self.sources)

    def close(self):
        """Stop the readers, join each within ``JOIN_TIMEOUT_S`` and release the captures."""
        self.running = False
        for t in self.threads:
            t.join(timeout=JOIN_TIMEOUT_S)
        for cap in self.caps:
            cap.release()

    def __len__(self):
        return len(self.sources)


class LoadScreenshots:
    """Screen-region capture (the JAX package's ``LoadScreenshots``, which needs ``mss``): not ported."""

    def __init__(self, source: str = "screen 0"):
        raise NotImplementedError(f"screen capture ({source!r}) is not ported yet (ROADMAP queue 1, item 26)")
