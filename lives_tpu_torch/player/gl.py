"""OpenGL playback sink over EGL.

Counterpart of `lives_tpu/player/gl.py:1-199` (reference
`lives-plugins/plugins/playback/video/openGL.cpp:1`: the frame uploaded
with glTexImage2D/glTexSubImage2D into a texture, drawn as a textured
quad, a vsync'd buffer swap). EGL hosts the context, so it runs headless
(a pbuffer surface, no X server). The frame arrives as a Layer on the
player's device, is converted to RGB24 there, and crosses to the host in
one copy, interleaved (H, W, 3), for the texture upload.

Gated: `load_libgl()` returns (egl, gl) or None where either library is
absent; `GLSink` takes injected libs, so the frame -> texture -> quad ->
swap path runs against a mock GL (tests/test_torch_display_sinks.py)
where no display exists.
"""

from __future__ import annotations

import ctypes

from ..constants import Palette
from ..layer import Layer
from .sinks import Sink, host_rgb24

# EGL constants (egl.h)
EGL_DEFAULT_DISPLAY = 0
EGL_NO_CONTEXT = 0
EGL_OPENGL_API = 0x30A2
EGL_SURFACE_TYPE = 0x3033
EGL_PBUFFER_BIT = 0x0001
EGL_RENDERABLE_TYPE = 0x3040
EGL_OPENGL_BIT = 0x0008
EGL_RED_SIZE = 0x3024
EGL_GREEN_SIZE = 0x3023
EGL_BLUE_SIZE = 0x3022
EGL_WIDTH = 0x3057
EGL_HEIGHT = 0x3056
EGL_NONE = 0x3038

# GL constants (gl.h) — the subset the reference upload path uses
# (openGL.cpp:569-597: GL_RGB/GL_RGBA/GL_BGRA upload into GL_RGB8 /
# GL_RGBA8 textures)
GL_TEXTURE_2D = 0x0DE1
GL_RGB = 0x1907
GL_RGB8 = 0x8051
GL_UNSIGNED_BYTE = 0x1401
GL_TEXTURE_MIN_FILTER = 0x2801
GL_TEXTURE_MAG_FILTER = 0x2800
GL_LINEAR = 0x2601
GL_CLAMP_TO_EDGE = 0x812F
GL_TEXTURE_WRAP_S = 0x2802
GL_TEXTURE_WRAP_T = 0x2803
GL_COLOR_BUFFER_BIT = 0x4000
GL_QUADS = 0x0007
GL_PROJECTION = 0x1701
GL_MODELVIEW = 0x1700
GL_UNPACK_ALIGNMENT = 0x0CF5


def load_libgl():
    """dlopen EGL + GL; None when either is unavailable (gated)."""
    try:
        egl = ctypes.CDLL("libEGL.so.1")
        gl = ctypes.CDLL("libGL.so.1")
    except OSError:
        return None
    return egl, gl


class GLSink(Sink):
    """Textured-quad GL display (videoplugin.h contract: init_screen /
    play_frame / exit_screen), EGL-hosted.

    Only the reference's mode-0 ("Normal") render path is implemented:
    one full-screen textured quad per frame (openGL.cpp:1052 mode
    switch, case 0). The trigger modes (cube/tunnel/particles/...) are
    VJ eye candy the effect chain covers on-device instead.
    """

    palette_list = (Palette.RGB24,)

    def __init__(self, fullscreen: bool = False, vsync: bool = True,
                 libs=None):
        libs = libs if libs is not None else load_libgl()
        if libs is None:
            raise RuntimeError("EGL/GL unavailable")
        self.egl, self.gl = libs
        self.fullscreen = fullscreen
        self.vsync = vsync
        self.display = None
        self.surface = None
        self.context = None
        self.texture = None
        self.size = (0, 0)
        self.frames_shown = 0

    # -- EGL bring-up -------------------------------------------------

    def init_screen(self, width: int, height: int, fps: float):
        egl = self.egl
        self.display = egl.eglGetDisplay(EGL_DEFAULT_DISPLAY)
        if not egl.eglInitialize(self.display, None, None):
            raise RuntimeError("eglInitialize failed")
        egl.eglBindAPI(EGL_OPENGL_API)
        attribs = (ctypes.c_int * 11)(
            EGL_SURFACE_TYPE, EGL_PBUFFER_BIT,
            EGL_RENDERABLE_TYPE, EGL_OPENGL_BIT,
            EGL_RED_SIZE, 8, EGL_GREEN_SIZE, 8, EGL_BLUE_SIZE, 8,
            EGL_NONE)
        cfg = ctypes.c_void_p()
        n = ctypes.c_int()
        if not egl.eglChooseConfig(self.display, attribs,
                                   ctypes.byref(cfg), 1, ctypes.byref(n)) \
                or n.value == 0:
            raise RuntimeError("eglChooseConfig found no config")
        pb = (ctypes.c_int * 5)(EGL_WIDTH, width, EGL_HEIGHT, height,
                                EGL_NONE)
        self.surface = egl.eglCreatePbufferSurface(self.display, cfg, pb)
        self.context = egl.eglCreateContext(self.display, cfg,
                                            EGL_NO_CONTEXT, None)
        if not egl.eglMakeCurrent(self.display, self.surface,
                                  self.surface, self.context):
            raise RuntimeError("eglMakeCurrent failed")
        if hasattr(egl, "eglSwapInterval"):
            egl.eglSwapInterval(self.display, 1 if self.vsync else 0)
        self._setup_texture(width, height)
        self.size = (width, height)

    def _setup_texture(self, width: int, height: int):
        gl = self.gl
        tex = ctypes.c_uint()
        gl.glGenTextures(1, ctypes.byref(tex))
        self.texture = tex
        gl.glBindTexture(GL_TEXTURE_2D, tex)
        gl.glTexParameteri(GL_TEXTURE_2D, GL_TEXTURE_MIN_FILTER, GL_LINEAR)
        gl.glTexParameteri(GL_TEXTURE_2D, GL_TEXTURE_MAG_FILTER, GL_LINEAR)
        gl.glTexParameteri(GL_TEXTURE_2D, GL_TEXTURE_WRAP_S,
                           GL_CLAMP_TO_EDGE)
        gl.glTexParameteri(GL_TEXTURE_2D, GL_TEXTURE_WRAP_T,
                           GL_CLAMP_TO_EDGE)
        # RGB24 rows are 3-byte aligned, not GL's default 4
        gl.glPixelStorei(GL_UNPACK_ALIGNMENT, 1)
        # allocate storage once (openGL.cpp:593 glTexImage2D with NULL
        # would also work; passing no data pointer means undefined
        # content until the first glTexSubImage2D below)
        gl.glTexImage2D(GL_TEXTURE_2D, 0, GL_RGB8, width, height, 0,
                        GL_RGB, GL_UNSIGNED_BYTE, None)
        gl.glEnable(GL_TEXTURE_2D)

    # -- per frame ----------------------------------------------------

    def play_frame(self, layer: Layer, tc: float) -> bool:
        w, h = layer.width, layer.height
        if self.size == (0, 0):
            self.init_screen(w, h, 25.0)
        gl = self.gl
        # one device -> host copy: (3, H, W) -> interleaved (H, W, 3)
        rgb = host_rgb24(layer)
        gl.glBindTexture(GL_TEXTURE_2D, self.texture)
        gl.glTexSubImage2D(GL_TEXTURE_2D, 0, 0, 0, w, h, GL_RGB,
                           GL_UNSIGNED_BYTE,
                           rgb.ctypes.data_as(ctypes.c_void_p))
        self._draw_quad()
        self.egl.eglSwapBuffers(self.display, self.surface)
        self.frames_shown += 1
        return True

    def _draw_quad(self):
        """Fixed-function textured quad (openGL.cpp mode 0)."""
        gl = self.gl
        gl.glClear(GL_COLOR_BUFFER_BIT)
        gl.glBegin(GL_QUADS)
        # texture is top-down, GL NDC is bottom-up: flip V
        for u, v, x, y in ((0, 1, -1, -1), (1, 1, 1, -1),
                           (1, 0, 1, 1), (0, 0, -1, 1)):
            gl.glTexCoord2f(ctypes.c_float(u), ctypes.c_float(v))
            gl.glVertex2f(ctypes.c_float(x), ctypes.c_float(y))
        gl.glEnd()

    def exit_screen(self):
        if self.display is not None:
            if self.texture is not None:
                self.gl.glDeleteTextures(1, ctypes.byref(self.texture))
                self.texture = None
            self.egl.eglMakeCurrent(self.display, 0, 0, EGL_NO_CONTEXT)
            if self.context is not None:
                self.egl.eglDestroyContext(self.display, self.context)
                self.context = None
            if self.surface is not None:
                self.egl.eglDestroySurface(self.display, self.surface)
                self.surface = None
            self.egl.eglTerminate(self.display)
            self.display = None
        self.size = (0, 0)
