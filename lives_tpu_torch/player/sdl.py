"""SDL2 local display sink.

Counterpart of `lives_tpu/player/sdl.py:1-148` (reference
`lives-plugins/plugins/playback/video/openGL.cpp:1` role: a local window
the player blits each frame into, fullscreen and vsync'd present). The
frame arrives as a Layer on the player's device, is converted to RGB24
there and crosses to the host in one copy, interleaved (H, W, 3), into a
streaming SDL texture.

ctypes binding, gated: `load_libsdl2()` returns None where SDL2 is
absent, and `SDLSink` takes an injected `lib`, so the blit path runs
headless against a mock (tests/test_torch_display_sinks.py). The console's
`play --sink sdl` builds one.
"""

from __future__ import annotations

import ctypes

from ..layer import Layer
from .sinks import Sink, host_rgb24

SDL_INIT_VIDEO = 0x20
SDL_WINDOWPOS_CENTERED = 0x2FFF0000
SDL_WINDOW_SHOWN = 0x4
SDL_WINDOW_FULLSCREEN_DESKTOP = 0x1001
SDL_PIXELFORMAT_RGB24 = 0x17101803
SDL_TEXTUREACCESS_STREAMING = 1
SDL_RENDERER_ACCELERATED = 0x2
SDL_RENDERER_PRESENTVSYNC = 0x4
SDL_QUIT_EVENT = 0x100


def load_libsdl2():
    """dlopen SDL2; None when unavailable (gated feature)."""
    for name in ("libSDL2-2.0.so.0", "libSDL2.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


class SDLSink(Sink):
    """Local display window (videoplugin.h contract: init_screen /
    play_frame / exit_screen; letterboxing is the graph's job)."""

    def __init__(self, title: str = "lives_tpu", fullscreen: bool = False,
                 vsync: bool = True, lib=None):
        self.lib = lib if lib is not None else load_libsdl2()
        if self.lib is None:
            raise RuntimeError("SDL2 unavailable")
        self.title = title
        self.fullscreen = fullscreen
        self.vsync = vsync
        self.window = None
        self.renderer = None
        self.texture = None
        self.size = (0, 0)
        self.frames_shown = 0
        if isinstance(self.lib, ctypes.CDLL):
            for name, restype, argtypes in (
                ("SDL_Init", ctypes.c_int, [ctypes.c_uint32]),
                ("SDL_CreateWindow", ctypes.c_void_p,
                 [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_uint32]),
                ("SDL_CreateRenderer", ctypes.c_void_p,
                 [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32]),
                ("SDL_CreateTexture", ctypes.c_void_p,
                 [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int]),
                ("SDL_UpdateTexture", ctypes.c_int,
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int]),
                ("SDL_RenderClear", ctypes.c_int, [ctypes.c_void_p]),
                ("SDL_RenderCopy", ctypes.c_int,
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p]),
                ("SDL_RenderPresent", None, [ctypes.c_void_p]),
                ("SDL_DestroyTexture", None, [ctypes.c_void_p]),
                ("SDL_DestroyRenderer", None, [ctypes.c_void_p]),
                ("SDL_DestroyWindow", None, [ctypes.c_void_p]),
                ("SDL_Quit", None, []),
                ("SDL_PollEvent", ctypes.c_int, [ctypes.c_void_p]),
            ):
                try:
                    fn = getattr(self.lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                except AttributeError:
                    pass

    # -- Sink contract (videoplugin.h:104-148) ------------------------------
    def init_screen(self, width: int, height: int, fps: float):
        lib = self.lib
        if lib.SDL_Init(SDL_INIT_VIDEO) != 0:
            raise RuntimeError("SDL_Init failed")
        flags = SDL_WINDOW_SHOWN | (
            SDL_WINDOW_FULLSCREEN_DESKTOP if self.fullscreen else 0)
        self.window = lib.SDL_CreateWindow(
            self.title.encode(), SDL_WINDOWPOS_CENTERED,
            SDL_WINDOWPOS_CENTERED, width, height, flags)
        if not self.window:
            raise RuntimeError("SDL_CreateWindow failed (no display?)")
        rflags = SDL_RENDERER_ACCELERATED | (
            SDL_RENDERER_PRESENTVSYNC if self.vsync else 0)
        self.renderer = lib.SDL_CreateRenderer(self.window, -1, rflags)
        self.texture = lib.SDL_CreateTexture(
            self.renderer, SDL_PIXELFORMAT_RGB24,
            SDL_TEXTUREACCESS_STREAMING, width, height)
        self.size = (width, height)

    def play_frame(self, layer: Layer, tc: float) -> bool:
        lib = self.lib
        if self.texture is None:
            self.init_screen(layer.width, layer.height, 25.0)
        # (3, H, W) on the device -> interleaved (H, W, 3) host bytes in
        # one copy
        arr = host_rgb24(layer)
        lib.SDL_UpdateTexture(self.texture, None,
                              arr.ctypes.data_as(ctypes.c_void_p),
                              arr.shape[1] * 3)
        lib.SDL_RenderClear(self.renderer)
        lib.SDL_RenderCopy(self.renderer, self.texture, None, None)
        lib.SDL_RenderPresent(self.renderer)
        self.frames_shown += 1
        # window close -> stop playback (exit_screen semantics)
        ev = (ctypes.c_uint8 * 64)()
        while lib.SDL_PollEvent(ctypes.byref(ev)):
            if int.from_bytes(bytes(ev[:4]), "little") == SDL_QUIT_EVENT:
                return False
        return True

    def exit_screen(self):
        lib = self.lib
        if self.texture:
            lib.SDL_DestroyTexture(self.texture)
            self.texture = None
        if self.renderer:
            lib.SDL_DestroyRenderer(self.renderer)
            self.renderer = None
        if self.window:
            lib.SDL_DestroyWindow(self.window)
            self.window = None
        lib.SDL_Quit()
