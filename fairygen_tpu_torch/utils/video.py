"""Media IO: saving and loading video frames (port of the frame parts of
fairygen_tpu/utils/video.py).

``save_video`` tries, in order: an mp4 through imageio (it needs an
ffmpeg backend), a GIF through PIL, then a directory of numbered PNGs.
Each step is taken only when the one before cannot write the file; the
path that was written is returned.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _to_uint8_frames(video) -> List[np.ndarray]:
    frames = []
    for f in video:
        a = np.asarray(f)
        if a.dtype != np.uint8:
            a = np.clip(a, 0, 255).astype(np.uint8)
        frames.append(a)
    return frames


def save_frames(video, save_path: str):
    """Frames -> numbered PNGs in the directory ``save_path``."""
    from PIL import Image

    os.makedirs(save_path, exist_ok=True)
    for i, frame in enumerate(_to_uint8_frames(video)):
        Image.fromarray(frame).save(os.path.join(save_path, f"{i:05d}.png"))
    return save_path


def _save_imageio(frames, save_path, fps, quality):
    import imageio

    writer = imageio.get_writer(save_path, fps=fps, quality=quality)
    try:
        for f in frames:
            writer.append_data(f)
    finally:
        writer.close()
    return save_path


def _save_gif(frames, save_path, fps):
    from PIL import Image

    if not save_path.lower().endswith(".gif"):
        save_path = os.path.splitext(save_path)[0] + ".gif"
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(save_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return save_path


def save_video(video, save_path: str, fps: int = 15, quality: int = 5):
    """Frames (uint8 HxWx3 arrays or PIL images) -> an mp4, else a GIF
    beside it, else a directory of PNGs beside it; returns what it wrote."""
    frames = _to_uint8_frames(video)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)) or ".", exist_ok=True)
    try:
        return _save_imageio(frames, save_path, fps, quality)
    except (ImportError, ValueError, RuntimeError, OSError) as e:
        print(f"[save_video] imageio could not write {save_path} ({type(e).__name__}); "
              "writing a GIF")
    try:
        return _save_gif(frames, save_path, fps)
    except (ValueError, OSError) as e:
        print(f"[save_video] PIL could not write a GIF ({type(e).__name__}); writing PNG frames")
    return save_frames(frames, os.path.splitext(save_path)[0])


class VideoData:
    """Frames of a video file (through imageio) or of a directory of images,
    opened lazily, optionally resized."""

    def __init__(self, video_file: Optional[str] = None, image_folder: Optional[str] = None,
                 height=None, width=None):
        self.height = height
        self.width = width
        if image_folder is not None:
            self._files = [os.path.join(image_folder, f) for f in sorted(os.listdir(image_folder))
                           if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))]
            self._reader = None
        else:
            import imageio

            self._reader = imageio.get_reader(video_file)
            self._files = None

    def __len__(self):
        if self._files is not None:
            return len(self._files)
        n = self._reader.get_length()
        if n == float("inf"):  # a stream that does not know its length: count
            n = self._reader.count_frames()
        return int(n)

    def __getitem__(self, i):
        from PIL import Image

        if self._files is not None:
            img = Image.open(self._files[i]).convert("RGB")
        else:
            img = Image.fromarray(self._reader.get_data(i))
        if self.height and self.width:
            img = img.resize((self.width, self.height))
        return img


def load_video_frames(path: str, height: Optional[int] = None, width: Optional[int] = None):
    """All frames of a video file or a frame directory as PIL images."""
    vd = (VideoData(image_folder=path, height=height, width=width) if os.path.isdir(path)
          else VideoData(video_file=path, height=height, width=width))
    return [vd[i] for i in range(len(vd))]
