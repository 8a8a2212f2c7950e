"""Dedicated-window viewer over raw Xlib (ctypes, no X11 headers needed);
the port's own copy of ``tiny_renderer_tpu.viewer_x11`` (NumPy only).

The reference displays frames in a real OS window with its own event
channel (show-image crate: src/app.rs:148-153 creates the window,
:213-218 blits each frame, :221-224 drains key events).  This module is
the native-window equivalent: a ctypes binding to libX11 that creates a
window, presents (H, W, 3) u8 frames via XPutImage, and decodes
KeyPress/KeyRelease/WM_DELETE events into the app's InputState callbacks
(keymap parity: a/d camera, q/e light, Esc exit — src/app.rs:63-77).

The Xlib handle is injectable (`X11Viewer(lib=...)`) so the full event
decode / present path is testable without a display.  On a host with no
display XOpenDisplay returns NULL and construction raises —
app.run_interactive falls back to matplotlib, then headless.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

# ---------------------------------------------------------------------------
# Minimal Xlib ABI surface (stable since X11R6; defined here because the
# image ships libX11.so.6 but no headers).
# ---------------------------------------------------------------------------

_Atom = ctypes.c_ulong
_Window = ctypes.c_ulong
_KeySym = ctypes.c_ulong

# Event type codes (X.h)
KEY_PRESS = 2
KEY_RELEASE = 3
CLIENT_MESSAGE = 33

# XSelectInput masks (X.h)
KEY_PRESS_MASK = 1 << 0
KEY_RELEASE_MASK = 1 << 1
STRUCTURE_NOTIFY_MASK = 1 << 17

ZPIXMAP = 2

# Keysyms (keysymdef.h) -> the app's key names.
KEYSYM_NAMES = {
    0x0061: "a",
    0x0064: "d",
    0x0065: "e",
    0x0071: "q",
    0xFF1B: "escape",
}


class XKeyEvent(ctypes.Structure):
    """Xlib.h XKeyEvent — layout is part of the stable ABI."""

    _fields_ = [
        ("type", ctypes.c_int),
        ("serial", ctypes.c_ulong),
        ("send_event", ctypes.c_int),
        ("display", ctypes.c_void_p),
        ("window", _Window),
        ("root", _Window),
        ("subwindow", _Window),
        ("time", ctypes.c_ulong),
        ("x", ctypes.c_int),
        ("y", ctypes.c_int),
        ("x_root", ctypes.c_int),
        ("y_root", ctypes.c_int),
        ("state", ctypes.c_uint),
        ("keycode", ctypes.c_uint),
        ("same_screen", ctypes.c_int),
    ]


class XClientMessageEvent(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_int),
        ("serial", ctypes.c_ulong),
        ("send_event", ctypes.c_int),
        ("display", ctypes.c_void_p),
        ("window", _Window),
        ("message_type", _Atom),
        ("format", ctypes.c_int),
        ("data", ctypes.c_long * 5),
    ]


class XEvent(ctypes.Union):
    """XEvent is a union padded to 24 longs (Xlib.h)."""

    _fields_ = [
        ("type", ctypes.c_int),
        ("xkey", XKeyEvent),
        ("xclient", XClientMessageEvent),
        ("pad", ctypes.c_long * 24),
    ]


def load_xlib():
    """ctypes CDLL for libX11 with the prototypes this viewer uses.

    Raises OSError when libX11 is absent.
    """
    name = ctypes.util.find_library("X11") or "libX11.so.6"
    lib = ctypes.CDLL(name)
    lib.XOpenDisplay.restype = ctypes.c_void_p
    lib.XOpenDisplay.argtypes = [ctypes.c_char_p]
    lib.XDefaultScreen.restype = ctypes.c_int
    lib.XDefaultScreen.argtypes = [ctypes.c_void_p]
    lib.XDefaultRootWindow.restype = _Window
    lib.XDefaultRootWindow.argtypes = [ctypes.c_void_p]
    lib.XDefaultDepth.restype = ctypes.c_int
    lib.XDefaultDepth.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.XDefaultVisual.restype = ctypes.c_void_p
    lib.XDefaultVisual.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.XDefaultGC.restype = ctypes.c_void_p
    lib.XDefaultGC.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.XCreateSimpleWindow.restype = _Window
    lib.XCreateSimpleWindow.argtypes = [
        ctypes.c_void_p, _Window,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_ulong, ctypes.c_ulong,
    ]
    lib.XStoreName.argtypes = [ctypes.c_void_p, _Window, ctypes.c_char_p]
    lib.XSelectInput.argtypes = [ctypes.c_void_p, _Window, ctypes.c_long]
    lib.XInternAtom.restype = _Atom
    lib.XInternAtom.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.XSetWMProtocols.argtypes = [
        ctypes.c_void_p, _Window, ctypes.POINTER(_Atom), ctypes.c_int
    ]
    lib.XMapWindow.argtypes = [ctypes.c_void_p, _Window]
    lib.XCreateImage.restype = ctypes.c_void_p
    lib.XCreateImage.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.XPutImage.argtypes = [
        ctypes.c_void_p, _Window, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint,
    ]
    lib.XPending.restype = ctypes.c_int
    lib.XPending.argtypes = [ctypes.c_void_p]
    lib.XNextEvent.argtypes = [ctypes.c_void_p, ctypes.POINTER(XEvent)]
    lib.XLookupKeysym.restype = _KeySym
    lib.XLookupKeysym.argtypes = [ctypes.POINTER(XKeyEvent), ctypes.c_int]
    lib.XFlush.argtypes = [ctypes.c_void_p]
    lib.XDestroyWindow.argtypes = [ctypes.c_void_p, _Window]
    lib.XCloseDisplay.argtypes = [ctypes.c_void_p]
    # For injecting a synthetic KeyPress through a real server.
    lib.XSendEvent.restype = ctypes.c_int
    lib.XSendEvent.argtypes = [
        ctypes.c_void_p, _Window, ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(XEvent),
    ]
    lib.XKeysymToKeycode.restype = ctypes.c_ubyte
    lib.XKeysymToKeycode.argtypes = [ctypes.c_void_p, _KeySym]
    lib.XSync.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


class X11Viewer:
    """Real-window backend with the MatplotlibViewer interface
    (connect/show/alive/close), used by app.run_interactive."""

    def __init__(self, width=800, height=800, title="tiny_renderer_tpu_torch", lib=None):
        self._x = lib if lib is not None else load_xlib()
        self._dpy = self._x.XOpenDisplay(None)
        if not self._dpy:
            raise RuntimeError("XOpenDisplay failed (no display)")
        screen = self._x.XDefaultScreen(self._dpy)
        depth = self._x.XDefaultDepth(self._dpy, screen)
        if depth not in (24, 32):
            self._x.XCloseDisplay(self._dpy)
            raise RuntimeError(f"unsupported default depth {depth}")
        self._w, self._h = int(width), int(height)
        self._win = self._x.XCreateSimpleWindow(
            self._dpy, self._x.XDefaultRootWindow(self._dpy),
            0, 0, self._w, self._h, 0, 0, 0,
        )
        self._x.XStoreName(self._dpy, self._win, title.encode())
        self._x.XSelectInput(
            self._dpy, self._win,
            KEY_PRESS_MASK | KEY_RELEASE_MASK | STRUCTURE_NOTIFY_MASK,
        )
        # Ask the WM to send a ClientMessage instead of killing us on close.
        self._wm_protocols = self._x.XInternAtom(self._dpy, b"WM_PROTOCOLS", 0)
        self._wm_delete = self._x.XInternAtom(
            self._dpy, b"WM_DELETE_WINDOW", 0
        )
        atom = _Atom(self._wm_delete)
        self._x.XSetWMProtocols(self._dpy, self._win, ctypes.byref(atom), 1)
        self._x.XMapWindow(self._dpy, self._win)

        # One persistent BGRX pixel buffer + XImage wrapping it.
        self._buf = ctypes.create_string_buffer(self._w * self._h * 4)
        self._img = self._x.XCreateImage(
            self._dpy, self._x.XDefaultVisual(self._dpy, screen), depth,
            ZPIXMAP, 0, self._buf, self._w, self._h, 32, self._w * 4,
        )
        if not self._img:
            self._x.XCloseDisplay(self._dpy)
            raise RuntimeError("XCreateImage failed")
        self._gc = self._x.XDefaultGC(self._dpy, screen)
        self._alive = True
        self._on_press = self._on_release = lambda key: None

    def connect(self, on_press, on_release):
        self._on_press = on_press
        self._on_release = on_release

    def _pump_events(self):
        ev = XEvent()
        while self._x.XPending(self._dpy) > 0:
            self._x.XNextEvent(self._dpy, ctypes.byref(ev))
            if ev.type in (KEY_PRESS, KEY_RELEASE):
                sym = self._x.XLookupKeysym(ctypes.byref(ev.xkey), 0)
                key = KEYSYM_NAMES.get(int(sym))
                if key is None:
                    continue
                if ev.type == KEY_PRESS:
                    self._on_press(key)
                else:
                    self._on_release(key)
            elif ev.type == CLIENT_MESSAGE:
                # Only WM_PROTOCOLS messages carry the close request; other
                # client messages (XDND etc.) must not close the window.
                if (
                    int(ev.xclient.message_type) == int(self._wm_protocols)
                    and int(ev.xclient.data[0]) == int(self._wm_delete)
                ):
                    self._alive = False

    def show(self, frame):
        """Blit an (H, W, 3) u8 RGB frame (row 0 = top, like imshow) and
        drain the event queue — the reference's per-frame set_image +
        try_iter pair (src/app.rs:216-224)."""
        h = min(self._h, frame.shape[0])
        w = min(self._w, frame.shape[1])
        # Write channels straight into the XImage's buffer (one copy, no
        # per-frame allocation — this is the interactive hot path).
        bgrx = np.frombuffer(self._buf, np.uint8).reshape(self._h, self._w, 4)
        bgrx[:h, :w, 0] = frame[:h, :w, 2]  # B
        bgrx[:h, :w, 1] = frame[:h, :w, 1]  # G
        bgrx[:h, :w, 2] = frame[:h, :w, 0]  # R
        self._x.XPutImage(
            self._dpy, self._win, self._gc, self._img,
            0, 0, 0, 0, self._w, self._h,
        )
        self._x.XFlush(self._dpy)
        self._pump_events()

    @property
    def alive(self) -> bool:
        return self._alive

    def close(self):
        if self._dpy:
            self._x.XDestroyWindow(self._dpy, self._win)
            self._x.XCloseDisplay(self._dpy)
            self._dpy = None
        self._alive = False
