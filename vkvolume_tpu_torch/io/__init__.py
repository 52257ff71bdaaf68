"""Raw volume files: the reference's header grammar and loader (host
numpy; the native loader when ``native/libvkvol_io.so`` is built)."""

from .header import Header, load_header, parse_header, write_header
from .loader import load_data, load_volume, normalise_to_u8, save_volume

__all__ = [
    "Header",
    "load_header",
    "parse_header",
    "write_header",
    "load_data",
    "load_volume",
    "normalise_to_u8",
    "save_volume",
]
