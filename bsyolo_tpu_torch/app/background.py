"""Static background extraction (counterpart of ``bsyolo_tpu/app/background.py``; reference
sys/generate background.py).

MOG2 GMM + frame differencing: the first frame with no significant motion is
saved as the background; falls back to the GMM background image. Pure host
OpenCV, as in the JAX package, imported when called (without it: ImportError
naming the ROADMAP item); this is offline preprocessing, not a device workload.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bsyolo_tpu_torch.utils import CV2_VIDEO, import_cv2


def extract_static_background(
    video_path: str,
    output_path: Optional[str] = None,
    motion_threshold: int = 1000,
    history: int = 500,
    var_threshold: int = 16,
) -> Optional[np.ndarray]:
    """Returns the background frame (BGR); optionally writes it to disk."""
    cv2 = import_cv2("extract_static_background (MOG2)", CV2_VIDEO)

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise FileNotFoundError(f"could not open video: {video_path}")
    bg_subtractor = cv2.createBackgroundSubtractorMOG2(
        history=history, varThreshold=var_threshold, detectShadows=True
    )
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
    last_frame = None
    background = None
    motion_pixel_count = motion_threshold
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            fg_gmm = bg_subtractor.apply(frame)
            if last_frame is not None:
                diff = cv2.absdiff(last_frame, frame)
                diff = cv2.cvtColor(diff, cv2.COLOR_BGR2GRAY)
                _, diff = cv2.threshold(diff, 30, 255, cv2.THRESH_BINARY)
                combined = cv2.bitwise_or(fg_gmm, diff)
            else:
                combined = fg_gmm
            combined = cv2.morphologyEx(combined, cv2.MORPH_OPEN, kernel)
            combined = cv2.morphologyEx(combined, cv2.MORPH_CLOSE, kernel)
            motion_pixel_count = cv2.countNonZero(combined)
            if motion_pixel_count < motion_threshold:
                background = frame
                break
            last_frame = frame
    finally:
        cap.release()
    if background is None:  # no motion-free frame: use the GMM's model
        background = bg_subtractor.getBackgroundImage()
    if background is not None and output_path:
        cv2.imwrite(str(output_path), background)
    return background
