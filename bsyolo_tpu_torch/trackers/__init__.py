"""Multi-object tracking (counterpart of ``bsyolo_tpu/trackers``; reference ultralytics/trackers/)."""

from bsyolo_tpu_torch.trackers.byte_tracker import BYTETracker
from bsyolo_tpu_torch.trackers.bot_sort import BOTSORT, BOTrack, ColorHistEncoder
from bsyolo_tpu_torch.trackers.track import create_tracker, track_results

__all__ = ["BYTETracker", "BOTSORT", "BOTrack", "ColorHistEncoder", "create_tracker", "track_results"]
