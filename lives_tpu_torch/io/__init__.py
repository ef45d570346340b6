"""Clip IO (counterpart of `lives_tpu/io/`): the YUV4MPEG2 decoder and
encoder, the clip model over a decoder's frames, and generator clips
(`genclip.GeneratorClip`, frames generated on the device)."""
