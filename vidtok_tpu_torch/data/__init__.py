"""Video data for the port's CLIs and datasets (``vidtok_tpu/data``):
decoding (the native FFmpeg library, else OpenCV, imported only when a
video is read or written), frame transforms on tensors, the datasets,
and the training input pipeline (:mod:`.pipeline`) and data module
(:mod:`.datamodule`)."""

from .dataset import VidTokDataset, VidTokValDataset, window_frame_ids
from .transforms import default_transform
from .video_reader import (read_frames_at, read_frames_u8, read_video_frames,
                           sample_frames_with_fps, video_info, write_video)

__all__ = [
    "read_frames_at",
    "read_frames_u8",
    "read_video_frames",
    "sample_frames_with_fps",
    "video_info",
    "write_video",
    "default_transform",
    "window_frame_ids",
    "VidTokDataset",
    "VidTokValDataset",
]
