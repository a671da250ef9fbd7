"""BoT-SORT tracker (counterpart of ``bsyolo_tpu/trackers/bot_sort.py``; reference
trackers/bot_sort.py). Host numpy, as in the JAX package; OpenCV only for the
GMC estimators that use it.

ByteTrack + three additions:
- XYWH Kalman state (KalmanFilterXYWH, reference kalman_filter.py:289)
- camera-motion compensation via GMC warps applied to predicted means
- appearance (ReID) association: per-detection embeddings smoothed with an
  EMA per track (alpha 0.9, reference BOTrack.update_features); the cost is
  min(iou_cost, emb_cost/2) with proximity + appearance gates
  (reference BOTSORT.get_dists).

The reference ships ReID disabled ("Haven't supported BoT-SORT(reid) yet",
reference bot_sort.py:193). Here the embedding hook is functional: pass any
``encoder(img, xyxy_boxes) -> (n, d)`` callable, or use the built-in
:class:`ColorHistEncoder` (HSV histogram) for a model-free appearance cue; it
converts with ``data/cv.py bgr2hsv`` (OpenCV's integer tables) and bins as
``cv2.calcHist`` does, so it needs no OpenCV.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np

from bsyolo_tpu_torch.data.cv import bgr2hsv
from bsyolo_tpu_torch.trackers import matching
from bsyolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack, TrackState
from bsyolo_tpu_torch.trackers.gmc import GMC
from bsyolo_tpu_torch.trackers.kalman import KalmanFilterXYWH

# cv2.calcHist's ranges for the H, S and V channels of an 8-bit HSV image
_HSV_RANGES = (180, 256, 256)


def _bin_table(bins: int, hi: int) -> np.ndarray:
    """calcHist's lookup table for one uniform 8-bit channel over [0, hi): floor(v * bins / hi) in
    double precision, as OpenCV computes it."""
    return np.clip(np.floor(np.arange(256) * (bins / hi)), 0, bins - 1).astype(np.int32)


class ColorHistEncoder:
    """HSV color-histogram appearance embedding (8x8x4 bins, L2-normalized).

    A deterministic, model-free ReID fallback: enough to separate vehicles
    of different colors under occlusion, with zero device cost.
    """

    def __init__(self, bins=(8, 8, 4)):
        self.bins = bins
        self._tables = [_bin_table(b, hi) for b, hi in zip(bins, _HSV_RANGES)]

    def __call__(self, img: np.ndarray, xyxy: np.ndarray) -> np.ndarray:
        d = int(np.prod(self.bins))
        out = np.zeros((len(xyxy), d), np.float32)
        h, w = img.shape[:2]
        boxes = np.array(xyxy, int).reshape(-1, 4)
        boxes[:, :2] = boxes[:, :2].clip(0)
        boxes[:, 2:] = np.minimum(boxes[:, 2:], (w, h))
        valid = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        out[~valid, 0] = 1.0
        if not valid.any():
            return out
        # HSV is per pixel, so the bin of every pixel under any box is computed once, on their union's
        # bounding rectangle, and each box's histogram counts a slice of it
        x0, y0 = boxes[valid, :2].min(0)
        x1, y1 = boxes[valid, 2:].max(0)
        hb, sb, vb = (t[c] for t, c in zip(self._tables, np.moveaxis(bgr2hsv(img[y0:y1, x0:x1]), -1, 0)))
        code = (hb * self.bins[1] + sb) * self.bins[2] + vb
        for i in np.flatnonzero(valid):
            bx1, by1, bx2, by2 = boxes[i]
            hist = np.bincount(code[by1 - y0:by2 - y0, bx1 - x0:bx2 - x0].ravel(), minlength=d).astype(np.float32)
            out[i] = hist / (np.linalg.norm(hist) + 1e-12)
        return out


class BOTrack(STrack):
    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xywh, score, cls, feat: Optional[np.ndarray] = None, feat_history: int = 50):
        super().__init__(xywh, score, cls)
        self.smooth_feat: Optional[np.ndarray] = None
        self.curr_feat: Optional[np.ndarray] = None
        self.features: deque = deque([], maxlen=feat_history)
        self.alpha = 0.9
        if feat is not None:
            self.update_features(feat)

    def update_features(self, feat: np.ndarray):
        """EMA-smoothed appearance (reference BOTrack.update_features)."""
        feat = feat / (np.linalg.norm(feat) + 1e-12)
        self.curr_feat = feat
        if self.smooth_feat is None:
            self.smooth_feat = feat
        else:
            self.smooth_feat = self.alpha * self.smooth_feat + (1 - self.alpha) * feat
            self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-12
        self.features.append(feat)

    def convert_coords(self, tlwh):
        """Measurement is plain xywh for the XYWH filter."""
        ret = np.asarray(tlwh, dtype=np.float32).copy()
        ret[:2] += ret[2:] / 2
        return ret

    @property
    def tlwh(self):
        """mean holds (x, y, w, h) directly (no aspect ratio)."""
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[:2] -= ret[2:] / 2
        return ret

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[6] = 0
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    @staticmethod
    def multi_predict(tracks: List["BOTrack"]):
        if not tracks:
            return
        means = np.stack([t.mean.copy() for t in tracks])
        covs = np.stack([t.covariance for t in tracks])
        for i, t in enumerate(tracks):
            if t.state != TrackState.Tracked:
                means[i][6] = 0
                means[i][7] = 0
        means, covs = BOTrack.shared_kalman.multi_predict(means, covs)
        for i, t in enumerate(tracks):
            t.mean, t.covariance = means[i], covs[i]

    def re_activate(self, new_track, frame_id, new_id=False):
        if getattr(new_track, "curr_feat", None) is not None:
            self.update_features(new_track.curr_feat)
        super().re_activate(new_track, frame_id, new_id)

    def update(self, new_track, frame_id):
        if getattr(new_track, "curr_feat", None) is not None:
            self.update_features(new_track.curr_feat)
        super().update(new_track, frame_id)


class BOTSORT(BYTETracker):
    def __init__(
        self,
        proximity_thresh: float = 0.5,
        appearance_thresh: float = 0.25,
        with_reid: bool = False,
        encoder=None,
        gmc_method: Optional[str] = "sparseOptFlow",
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.proximity_thresh = proximity_thresh
        self.appearance_thresh = appearance_thresh
        self.with_reid = with_reid
        self.encoder = encoder or (ColorHistEncoder() if with_reid else None)
        self.kalman_filter = KalmanFilterXYWH()
        self.gmc = GMC(method=gmc_method) if gmc_method not in (None, "none", "None") else None

    def reset(self):
        super().reset()
        if getattr(self, "gmc", None) is not None:
            self.gmc.reset()

    def init_track(self, boxes, scores, cls, img=None):
        if len(boxes) == 0:
            return []
        if self.with_reid and self.encoder is not None and img is not None:
            xyxy = np.stack(
                [
                    boxes[:, 0] - boxes[:, 2] / 2,
                    boxes[:, 1] - boxes[:, 3] / 2,
                    boxes[:, 0] + boxes[:, 2] / 2,
                    boxes[:, 1] + boxes[:, 3] / 2,
                ],
                axis=-1,
            )
            feats = self.encoder(img, xyxy)
            return [BOTrack(b, s, c, f) for b, s, c, f in zip(boxes, scores, cls, feats)]
        return [BOTrack(b, s, c) for b, s, c in zip(boxes, scores, cls)]

    def multi_predict(self, tracks):
        BOTrack.multi_predict(tracks)

    def get_dists(self, tracks, detections):
        """IoU gated + appearance fused cost (reference BOTSORT.get_dists)."""
        dists = matching.iou_distance(tracks, detections)
        dists_mask = dists > self.proximity_thresh
        if self.fuse_score:
            dists = matching.fuse_score(dists, detections)
        if self.with_reid and self.encoder is not None and len(tracks) and len(detections):
            emb = matching.embedding_distance(tracks, detections) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        return dists
