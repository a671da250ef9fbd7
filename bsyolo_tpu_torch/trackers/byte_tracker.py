"""ByteTrack multi-object tracker (counterpart of ``bsyolo_tpu/trackers/byte_tracker.py``).

Host numpy, as in the JAX package. ``STrack``'s id counter is class state of
this module, apart from the JAX package's. Reference: ultralytics/trackers/byte_tracker.py (BYTETracker.update:293,
STrack:12). Two-stage association: high-confidence detections matched by
(optionally score-fused) IoU Hungarian at match_thresh; low-confidence rescue
pass at 0.5; unconfirmed-track handling at 0.7; 30-frame lost buffer.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from bsyolo_tpu_torch.trackers import matching
from bsyolo_tpu_torch.trackers.gmc import GMC
from bsyolo_tpu_torch.trackers.kalman import KalmanFilterXYAH


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class STrack:
    shared_kalman = KalmanFilterXYAH()
    _count = 0

    def __init__(self, xywh, score, cls):
        # xywh: (cx, cy, w, h, [idx]) — idx is the detection row index
        self._tlwh = np.asarray(
            [xywh[0] - xywh[2] / 2, xywh[1] - xywh[3] / 2, xywh[2], xywh[3]], dtype=np.float32
        )
        self.kalman_filter: Optional[KalmanFilterXYAH] = None
        self.mean, self.covariance = None, None
        self.is_activated = False
        self.score = float(score)
        self.cls = cls
        self.idx = int(xywh[-1])
        self.state = TrackState.New
        self.tracklet_len = 0
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0

    @staticmethod
    def next_id():
        STrack._count += 1
        return STrack._count

    @staticmethod
    def reset_id():
        STrack._count = 0

    @staticmethod
    def tlwh_to_xyah(tlwh):
        ret = np.asarray(tlwh, dtype=np.float32).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    @property
    def end_frame(self):
        return self.frame_id

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[2] *= ret[3]
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def xyxy(self):
        ret = self.tlwh.copy()
        ret[2:] += ret[:2]
        return ret

    @property
    def result(self):
        return self.xyxy.tolist() + [self.track_id, self.score, float(self.cls), self.idx]

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    @staticmethod
    def multi_predict(tracks: List["STrack"]):
        if not tracks:
            return
        means = np.stack([t.mean.copy() for t in tracks])
        covs = np.stack([t.covariance for t in tracks])
        for i, t in enumerate(tracks):
            if t.state != TrackState.Tracked:
                means[i][7] = 0
        means, covs = STrack.shared_kalman.multi_predict(means, covs)
        for i, t in enumerate(tracks):
            t.mean, t.covariance = means[i], covs[i]

    def convert_coords(self, tlwh):
        """Measurement-space conversion; XYAH here, XYWH in BOTrack
        (reference byte_tracker.py STrack.convert_coords)."""
        return self.tlwh_to_xyah(tlwh)

    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = self.kalman_filter.initiate(self.convert_coords(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track: "STrack", frame_id, new_id=False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.convert_coords(new_track.tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def update(self, new_track: "STrack", frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.convert_coords(new_track.tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed


class BYTETracker:
    """Reference-compatible ByteTrack (byte_tracker.py:236-476)."""

    def __init__(
        self,
        track_high_thresh: float = 0.25,
        track_low_thresh: float = 0.1,
        new_track_thresh: float = 0.25,
        track_buffer: int = 30,
        match_thresh: float = 0.8,
        fuse_score: bool = True,
        frame_rate: int = 30,
    ):
        self.track_high_thresh = track_high_thresh
        self.track_low_thresh = track_low_thresh
        self.new_track_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.fuse_score = fuse_score
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.kalman_filter = KalmanFilterXYAH()
        self.reset()

    def reset(self):
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []
        self.frame_id = 0
        STrack.reset_id()

    def init_track(self, boxes, scores, cls, img=None):
        """Detection -> track-candidate construction (BOTSORT adds ReID feats)."""
        return [STrack(b, s, c) for b, s, c in zip(boxes, scores, cls)]

    def multi_predict(self, tracks):
        STrack.multi_predict(tracks)

    def get_dists(self, tracks, detections):
        dists = matching.iou_distance(tracks, detections)
        if self.fuse_score:
            dists = matching.fuse_score(dists, detections)
        return dists

    def update(self, xywh: np.ndarray, conf: np.ndarray, cls: np.ndarray, img=None) -> np.ndarray:
        """One tracking step.

        Args:
            xywh: (n, 4) detection boxes (cx, cy, w, h) in pixels.
            conf: (n,) confidences; cls: (n,) class indices.
            img: optional frame (BGR) for camera-motion compensation.

        Returns:
            (m, 8) array: x1, y1, x2, y2, track_id, score, cls, det_idx.
        """
        self.frame_id += 1
        activated, refind, lost, removed = [], [], [], []

        boxes = np.concatenate([np.asarray(xywh, np.float32).reshape(-1, 4),
                                np.arange(len(conf)).reshape(-1, 1)], axis=-1)
        conf = np.asarray(conf)
        # a box of zero width or height has no aspect ratio and no extent to match: the JAX package's
        # tracker turns it into NaN rows and fails in the next frame's assignment; here it is not tracked
        sized = (boxes[:, 2] > 0) & (boxes[:, 3] > 0)
        first = sized & (conf >= self.track_high_thresh)
        second = sized & (conf > self.track_low_thresh) & (conf < self.track_high_thresh)
        detections = self.init_track(boxes[first], conf[first], np.asarray(cls)[first], img)
        detections_second = self.init_track(
            boxes[second], conf[second], np.asarray(cls)[second], img
        )

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]

        # first association on high-confidence detections
        strack_pool = _joint(tracked, self.lost_stracks)
        self.multi_predict(strack_pool)
        if getattr(self, "gmc", None) is not None and img is not None:
            # BoT-SORT camera-motion compensation (reference bot_sort.py +
            # byte_tracker.py:330-333 multi_gmc)
            warp = self.gmc.apply(img)
            GMC.warp_track_means(strack_pool, warp)
            GMC.warp_track_means(unconfirmed, warp)
        dists = self.get_dists(strack_pool, detections)
        matches, u_track, u_det = matching.linear_assignment(dists, thresh=self.match_thresh)
        for it, idet in matches:
            track, det = strack_pool[it], detections[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)

        # second association: rescue with low-confidence detections
        r_tracked = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists = matching.iou_distance(r_tracked, detections_second)
        matches, u_track2, _ = matching.linear_assignment(dists, thresh=0.5)
        for it, idet in matches:
            track, det = r_tracked[it], detections_second[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)
        for i in u_track2:
            t = r_tracked[i]
            if t.state != TrackState.Lost:
                t.mark_lost()
                lost.append(t)

        # unconfirmed tracks vs leftover high-confidence detections
        detections = [detections[i] for i in u_det]
        dists = self.get_dists(unconfirmed, detections)
        matches, u_unconfirmed, u_det = matching.linear_assignment(dists, thresh=0.7)
        for it, idet in matches:
            unconfirmed[it].update(detections[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconfirmed:
            t = unconfirmed[i]
            t.mark_removed()
            removed.append(t)

        # new tracks
        for i in u_det:
            det = detections[i]
            if det.score >= self.new_track_thresh:
                det.activate(self.kalman_filter, self.frame_id)
                activated.append(det)

        # prune stale lost tracks
        for t in self.lost_stracks:
            if self.frame_id - t.end_frame > self.max_time_lost:
                t.mark_removed()
                removed.append(t)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = _joint(self.tracked_stracks, activated)
        self.tracked_stracks = _joint(self.tracked_stracks, refind)
        self.lost_stracks = _sub(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = _sub(self.lost_stracks, self.removed_stracks)
        self.tracked_stracks, self.lost_stracks = _remove_duplicates(
            self.tracked_stracks, self.lost_stracks
        )
        self.removed_stracks.extend(removed)
        if len(self.removed_stracks) > 1000:
            self.removed_stracks = self.removed_stracks[-999:]

        out = [t.result for t in self.tracked_stracks if t.is_activated]
        return np.asarray(out, dtype=np.float32) if out else np.zeros((0, 8), np.float32)


def _joint(a: List[STrack], b: List[STrack]) -> List[STrack]:
    seen = {}
    for t in a + b:
        if t.track_id not in seen:
            seen[t.track_id] = t
    return list(seen.values())


def _sub(a: List[STrack], b: List[STrack]) -> List[STrack]:
    ids = {t.track_id for t in b}
    return [t for t in a if t.track_id not in ids]


def _remove_duplicates(a: List[STrack], b: List[STrack]):
    if not a or not b:
        return a, b
    d = matching.iou_distance(a, b)
    pairs = np.where(d < 0.15)
    dup_a, dup_b = set(), set()
    for ia, ib in zip(*pairs):
        timep = a[ia].frame_id - a[ia].start_frame
        timeq = b[ib].frame_id - b[ib].start_frame
        if timep > timeq:
            dup_b.add(ib)
        else:
            dup_a.add(ia)
    return [t for i, t in enumerate(a) if i not in dup_a], [t for i, t in enumerate(b) if i not in dup_b]
