"""Global motion compensation for BoT-SORT (counterpart of ``bsyolo_tpu/trackers/gmc.py``;
reference trackers/utils/gmc.py).

Host OpenCV, as in the JAX package, imported only by the estimators that use
it: ``method="none"`` builds and runs without OpenCV, and an OpenCV estimator
where it is not installed raises ImportError naming the ROADMAP item.

Four estimators matching the reference's method set (gmc.py:11):

- ``sparseOptFlow`` (default): Shi-Tomasi corners + pyramidal Lucas-Kanade
  flow, partial-affine RANSAC fit.
- ``orb``: FAST keypoints + ORB descriptors, Hamming cross-check matching.
- ``sift``: SIFT keypoints/descriptors, L2 ratio-test matching.
- ``ecc``: direct intensity alignment via findTransformECC (euclidean).

All return a 2x3 affine warp from the previous frame to the current one;
the tracker applies it to predicted track means/covariances before
association.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bsyolo_tpu_torch.utils import CV2_VIDEO, import_cv2

_NONE = (None, "none", "None")


def _cv2():
    return import_cv2("camera-motion compensation (gmc_method sparseOptFlow, orb, sift or ecc)", CV2_VIDEO)


class GMC:
    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        if method not in ("sparseOptFlow", "orb", "sift", "ecc") + _NONE:
            raise ValueError(f"unknown GMC method: {method}")
        self.method = method
        self.downscale = max(1, downscale)
        self.prev_gray: Optional[np.ndarray] = None
        self.prev_pts = None
        self.prev_kps = None
        self.prev_desc = None
        if method == "orb":
            cv2 = _cv2()
            self.detector = cv2.FastFeatureDetector_create(20)
            self.extractor = cv2.ORB_create()
            self.matcher = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
        elif method == "sift":
            cv2 = _cv2()
            self.detector = cv2.SIFT_create(
                nOctaveLayers=3, contrastThreshold=0.02, edgeThreshold=20
            )
            self.extractor = self.detector
            self.matcher = cv2.BFMatcher(cv2.NORM_L2)
        elif method not in _NONE:
            _cv2()  # sparseOptFlow, ecc: refuse at construction where OpenCV is missing, as the JAX package does

    def reset(self):
        self.prev_gray = None
        self.prev_pts = None
        self.prev_kps = None
        self.prev_desc = None

    def _prep(self, frame: np.ndarray) -> np.ndarray:
        cv2 = _cv2()

        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        if self.downscale > 1:
            gray = cv2.resize(
                gray, (gray.shape[1] // self.downscale, gray.shape[0] // self.downscale)
            )
        return gray

    def _fit(self, p0: np.ndarray, p1: np.ndarray) -> Optional[np.ndarray]:
        cv2 = _cv2()

        if len(p0) < 4:
            return None
        M, _ = cv2.estimateAffinePartial2D(p0, p1, method=cv2.RANSAC)
        return None if M is None else M.astype(np.float32)

    def apply(self, frame: np.ndarray, detections=None) -> np.ndarray:
        """Returns a 2x3 affine warp from the previous frame to this one."""
        H = np.eye(2, 3, dtype=np.float32)
        if self.method in _NONE:
            return H
        gray = self._prep(frame)
        if self.method == "sparseOptFlow":
            H = self._apply_sparse_flow(gray, H)
        elif self.method == "ecc":
            H = self._apply_ecc(gray, H)
        else:  # orb / sift
            H = self._apply_features(gray, H)
        if self.downscale > 1:  # rescale translation back to full res
            H = H.copy()
            H[0, 2] *= self.downscale
            H[1, 2] *= self.downscale
        return H

    def _apply_sparse_flow(self, gray, H):
        cv2 = _cv2()

        pts = cv2.goodFeaturesToTrack(
            gray, maxCorners=1000, qualityLevel=0.01, minDistance=1, blockSize=3,
            useHarrisDetector=False, k=0.04,
        )
        if self.prev_gray is None or self.prev_pts is None or pts is None:
            self.prev_gray, self.prev_pts = gray, pts
            return H
        nxt, status, _ = cv2.calcOpticalFlowPyrLK(self.prev_gray, gray, self.prev_pts, None)
        if nxt is not None and status is not None:
            ok = status.flatten() == 1
            M = self._fit(self.prev_pts[ok].reshape(-1, 2), nxt[ok].reshape(-1, 2))
            if M is not None:
                H = M
        self.prev_gray, self.prev_pts = gray, pts
        return H

    def _apply_ecc(self, gray, H):
        cv2 = _cv2()

        if self.prev_gray is None:
            self.prev_gray = gray
            return H
        warp = np.eye(2, 3, dtype=np.float32)
        criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 100, 1e-5)
        try:
            # gaussFiltSize=5: ECC is intensity-gradient based and needs
            # smoothing to converge on high-frequency content
            _, warp = cv2.findTransformECC(
                self.prev_gray, gray, warp, cv2.MOTION_EUCLIDEAN, criteria, None, 5
            )
            H = warp.astype(np.float32)
        except cv2.error:  # no convergence: identity
            pass
        self.prev_gray = gray
        return H

    def _apply_features(self, gray, H):
        kps = self.detector.detect(gray, None)
        kps, desc = self.extractor.compute(gray, kps)
        if self.prev_gray is None or self.prev_desc is None or desc is None or len(kps) == 0:
            self.prev_gray, self.prev_kps, self.prev_desc = gray, kps, desc
            return H
        if self.method == "orb":
            matches = self.matcher.match(self.prev_desc, desc)
        else:  # sift ratio test
            knn = self.matcher.knnMatch(self.prev_desc, desc, k=2)
            matches = [m for m, n in (p for p in knn if len(p) == 2) if m.distance < 0.75 * n.distance]
        if len(matches) >= 4:
            p0 = np.float32([self.prev_kps[m.queryIdx].pt for m in matches])
            p1 = np.float32([kps[m.trainIdx].pt for m in matches])
            M = self._fit(p0, p1)
            if M is not None:
                H = M
        self.prev_gray, self.prev_kps, self.prev_desc = gray, kps, desc
        return H

    @staticmethod
    def warp_track_means(tracks, H: np.ndarray):
        """Apply the warp to track means + covariances (reference
        STrack.multi_gmc, byte_tracker.py:330: R ⊗ I4 on the 8-state)."""
        if len(tracks) == 0:
            return
        R = H[:2, :2].astype(np.float64)
        t = H[:2, 2].astype(np.float64)
        R8 = np.kron(np.eye(4), R)
        for tr in tracks:
            if tr.mean is None:
                continue
            mean = R8 @ tr.mean
            mean[:2] += t
            tr.mean = mean
            tr.covariance = R8 @ tr.covariance @ R8.T
