"""Utilities of the port."""

import logging

LOGGER = logging.getLogger("bsyolo_tpu_torch")

# ROADMAP items that remove the port's remaining OpenCV calls, by what the call does
CV2_VIDEO = "queue 1, item 24"  # video decode and encode, MOG2 background, GMC's feature and flow estimators
CV2_DRAWING = "queue 1, item 25"  # rectangles, text and polylines on frames


def import_cv2(what: str, item: str):
    """OpenCV, imported when ``what`` needs it (the port's functions that touch the card never do);
    where it is not installed, an ImportError that names the ROADMAP ``item`` that removes the need."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not installed; doing it without OpenCV is "
                          f"ROADMAP {item}") from e
    return cv2
