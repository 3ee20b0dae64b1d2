"""The offline tracker (port of detzero_tpu/models/tracking: numpy and
scipy, no torch)."""

from detzero_tpu_torch.models.tracking.tracker import DetZeroTracker
from detzero_tpu_torch.models.tracking.track_manager import TrackManager
from detzero_tpu_torch.models.tracking.post_process import PostProcessor
