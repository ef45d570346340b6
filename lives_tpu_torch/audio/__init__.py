"""Audio engine (reference L8, src/audio.c): counterpart of
`lives_tpu/audio/__init__.py:1-9`. `engine` converts, resamples, mixes and
renders an event list's audio; `fx` holds the audio filter registry, the
sinks and the realtime feeder the player attaches; importing `analysers`
registers `audio_fft` and `beat_detector`."""

from .engine import (db_to_gain, gain_to_db, mix_tracks, render_audio,
                     render_timeline_audio, resample, sample_convert,
                     velocity_resample)
from .fx import (AlsaAudioSink, AudioPlayer, NullAudioSink, PipeAudioSink,
                 PulseAudioSink, WavAudioSink, audio_instantiate,
                 best_audio_sink, list_audio_filters, tone_gen)
from . import analysers  # registers audio_fft / beat_detector
