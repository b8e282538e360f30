"""Media IO: saving and loading video frames, reading a wav and muxing it
into a saved video (port of fairygen_tpu/utils/video.py).

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


def load_wav(path: str):
    """A PCM ``.wav`` -> (mono float32 waveform in [-1, 1], sample rate):
    8-bit unsigned, 16-bit, packed 24-bit and 32-bit signed little-endian
    samples; several channels are averaged."""
    import wave

    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        width = f.getsampwidth()
        n_ch = f.getnchannels()
        raw = f.readframes(f.getnframes())
    if width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:  # widen to int32 with a zero low byte
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        i32 = np.zeros((b.shape[0], 4), np.uint8)
        i32[:, 1:] = b
        data = i32.view("<i4")[:, 0].astype(np.float32) / 2147483648.0
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported wav sample width: {width} bytes")
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data, sr


def merge_video_audio(video_path: str, audio_path: str):
    """Mux an audio track into a saved video with ffmpeg (the video stream
    copied, the audio AAC, trimmed to the shorter); raises when ffmpeg is
    missing or fails."""
    import shutil
    import subprocess

    for p in (video_path, audio_path):
        if not os.path.exists(p):
            raise FileNotFoundError(f"{p} does not exist")
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        try:
            import imageio_ffmpeg

            ffmpeg = imageio_ffmpeg.get_ffmpeg_exe()
        except Exception as e:
            raise RuntimeError("no ffmpeg available to mux audio") from e
    base, ext = os.path.splitext(video_path)
    temp_output = f"{base}_temp{ext}"
    command = [ffmpeg, "-y", "-i", video_path, "-i", audio_path, "-c:v", "copy", "-c:a", "aac",
               "-b:a", "192k", "-map", "0:v:0", "-map", "1:a:0", "-shortest", temp_output]
    try:
        result = subprocess.run(command, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        if result.returncode != 0:
            raise RuntimeError(f"ffmpeg failed: {result.stderr[-2000:]}")
        shutil.move(temp_output, video_path)
    except Exception:
        if os.path.exists(temp_output):
            os.remove(temp_output)
        raise


def save_video_with_audio(video, save_path: str, audio_path: str, fps: int = 16,
                          quality: int = 9):
    """:func:`save_video`, then the driving audio muxed in (S2V outputs)."""
    out = save_video(video, save_path, fps=fps, quality=quality)
    merge_video_audio(out, audio_path)
    return out
