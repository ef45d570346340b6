"""Clip IO (counterpart of `lives_tpu/io/`): the image-sequence,
YUV4MPEG2, WAV and AVI decoders and the fifo reader, the encoders, the
clip store over a decoder's frames and numbered images, generator clips
(`genclip.GeneratorClip`, frames generated on the device), the MJPEG
lanes, the in-process libav lane (`av`) and scrap capture.

Importing the package registers `av.AVDecoder` after the decoders of
`decoders.py` (`lives_tpu/io/__init__.py:6`): an MJPEG `.avi` opens with
`AVIDecoder` and the device JPEG lane, and `open_clip` reaches libav for
the containers no earlier decoder claims; `decoders.FFmpegDecoder` comes
last, where `ffmpeg` and `ffprobe` are on PATH."""

from . import av  # noqa: F401  (registers AVDecoder)
from .decoders import FFmpegDecoder, register_decoder

register_decoder(FFmpegDecoder)   # last, as in the JAX registry
