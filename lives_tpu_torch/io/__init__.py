"""Clip IO (counterpart of `lives_tpu/io/`): the image-sequence,
YUV4MPEG2, WAV and AVI decoders and the fifo reader, the encoders, the
clip store over a decoder's frames and numbered images, generator clips
(`genclip.GeneratorClip`, frames generated on the device), the MJPEG
lanes and scrap capture."""
