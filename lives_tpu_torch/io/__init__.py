"""Clip IO, host side (counterpart of `lives_tpu/io/`): the YUV4MPEG2
decoder and encoder, and the clip model over a decoder's frames."""
