"""V4L2 webcam capture.

Counterpart of `lives_tpu/io/videodev.py:1-132` (reference
`src/videodev.c` via unicap). A pure-ctypes V4L2 host with mmap streaming
IO: negotiate YUYV or MJPEG, queue buffers, serve the newest frame as a
Layer (CLIP_TYPE_VIDEODEV) on the source's torch device (`torch_device`,
the card unless the caller asks for the CPU; `device` is the V4L2 node,
as in the JAX package). YUYV crosses to the device as its bytes
(`layer_from_bytes`); MJPEG decodes through PIL on the host, as in the
JAX package (`videodev.py:97-122`), and crosses as RGB24. Gated on
/dev/video* presence: where no camera exists `list_devices()` is empty.
`/clip/open/unicap` opens one on the player's device.
"""

from __future__ import annotations

import ctypes
import fcntl
import mmap
import os
import select
import struct
from pathlib import Path

import numpy as np
import torch

from ..constants import Palette, YUVClamping
from ..layer import Layer, layer_from_bytes

# V4L2 ioctls (videodev2.h)
VIDIOC_QUERYCAP = 0x80685600
VIDIOC_S_FMT = 0xC0D05605
VIDIOC_REQBUFS = 0xC0145608
VIDIOC_QUERYBUF = 0xC0585609
VIDIOC_QBUF = 0xC058560F
VIDIOC_DQBUF = 0xC0585611
VIDIOC_STREAMON = 0x40045612
VIDIOC_STREAMOFF = 0x40045613

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_PIX_FMT_YUYV = 0x56595559  # 'YUYV'
V4L2_PIX_FMT_MJPEG = 0x47504A4D  # 'MJPG'


def list_devices() -> list[str]:
    return sorted(str(p) for p in Path("/dev").glob("video*"))


def frame_layer(data: bytes, pixfmt: int, width: int, height: int,
                device: torch.device | str) -> Layer:
    """One dequeued V4L2 buffer as a Layer on `device`: YUYV as its bytes
    (clamped range), MJPEG decoded by PIL on the host to RGB24."""
    if pixfmt == V4L2_PIX_FMT_YUYV:
        return layer_from_bytes(data, width, height, Palette.YUYV,
                                device=device,
                                clamping=int(YUVClamping.CLAMPED))
    if pixfmt == V4L2_PIX_FMT_MJPEG:
        import io

        from PIL import Image
        with Image.open(io.BytesIO(data)) as im:
            arr = np.asarray(im.convert("RGB"))
        return Layer(planes=(torch.from_numpy(
            np.moveaxis(arr, -1, 0).copy()).to(device),),
            palette=int(Palette.RGB24))
    raise RuntimeError(f"unsupported pixfmt {pixfmt:#x}")


class V4L2Source:
    """Clip-like live camera source."""

    def __init__(self, device: str = "/dev/video0", width: int = 640,
                 height: int = 480, n_buffers: int = 4, *,
                 torch_device: torch.device | str = "cuda"):
        self.device = device
        self.torch_device = torch.device(torch_device)
        self.width, self.height = width, height
        self.fps = 30.0
        self.frames = 1 << 30
        from ..utils.uid import stable_uid
        self.unique_id = stable_uid("v4l2", device)
        self.scrap_on_record = True  # live feed: recordings scrap frames
        self.fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        self.pixfmt = V4L2_PIX_FMT_YUYV
        self._set_format()
        self._buffers = self._map_buffers(n_buffers)
        self._streamon()

    # struct v4l2_format for VIDEO_CAPTURE: type u32, pad, pix struct
    def _set_format(self):
        fmt = bytearray(208)
        struct.pack_into("<I", fmt, 0, V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("<IIII", fmt, 8, self.width, self.height,
                         self.pixfmt, 1)  # field=NONE? (1)
        fcntl.ioctl(self.fd, VIDIOC_S_FMT, fmt)
        w, h, pix = struct.unpack_from("<III", fmt, 8)
        self.width, self.height, self.pixfmt = w, h, pix

    def _map_buffers(self, n):
        req = bytearray(20)
        struct.pack_into("<III", req, 0, n, V4L2_BUF_TYPE_VIDEO_CAPTURE,
                         V4L2_MEMORY_MMAP)
        fcntl.ioctl(self.fd, VIDIOC_REQBUFS, req)
        count = struct.unpack_from("<I", req, 0)[0]
        bufs = []
        for i in range(count):
            b = bytearray(88)
            struct.pack_into("<I", b, 0, i)          # index
            struct.pack_into("<I", b, 4, V4L2_BUF_TYPE_VIDEO_CAPTURE)
            struct.pack_into("<I", b, 40, V4L2_MEMORY_MMAP)
            fcntl.ioctl(self.fd, VIDIOC_QUERYBUF, b)
            length = struct.unpack_from("<I", b, 48)[0]
            offset = struct.unpack_from("<I", b, 52)[0]
            mm = mmap.mmap(self.fd, length, mmap.MAP_SHARED,
                           mmap.PROT_READ, offset=offset)
            bufs.append(mm)
            fcntl.ioctl(self.fd, VIDIOC_QBUF, b)
        return bufs

    def _streamon(self):
        fcntl.ioctl(self.fd, VIDIOC_STREAMON,
                    struct.pack("<I", V4L2_BUF_TYPE_VIDEO_CAPTURE))

    def get_frame(self, n: int = 0) -> Layer:
        """Dequeue the newest frame (n ignored: live source)."""
        select.select([self.fd], [], [], 2.0)
        b = bytearray(88)
        struct.pack_into("<I", b, 4, V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("<I", b, 40, V4L2_MEMORY_MMAP)
        fcntl.ioctl(self.fd, VIDIOC_DQBUF, b)
        idx = struct.unpack_from("<I", b, 0)[0]
        used = struct.unpack_from("<I", b, 44)[0]
        data = self._buffers[idx][:used]
        fcntl.ioctl(self.fd, VIDIOC_QBUF, b)
        return frame_layer(bytes(data), self.pixfmt, self.width,
                           self.height, self.torch_device)

    def close(self):
        try:
            fcntl.ioctl(self.fd, VIDIOC_STREAMOFF,
                        struct.pack("<I", V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        for mm in self._buffers:
            mm.close()
        os.close(self.fd)
