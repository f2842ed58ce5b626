"""Native (C++) image decode and resize, loaded with ctypes and built with
g++ at first use."""

from .build import decoder_name, load_library  # noqa: F401
