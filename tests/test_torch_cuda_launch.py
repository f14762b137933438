"""The one launch path of the port's CUDA wrappers (``ops/cuda/build.py``),
on the CPU with stand-in C entries: :func:`build.entry` binds a symbol with
the stream handle as its last argument and an int status, once;
:func:`build.launch` appends the current stream, raises on a nonzero status
and counts only the launches that returned 0, under the wrapper's name."""

import collections
import ctypes

import pytest

from collab_splats_tpu_torch.ops.cuda import build

NAME = "stand_in_entry"


@pytest.fixture
def counter(monkeypatch):
    """A fresh launch counter, and a stand-in for the current stream's
    handle (there is no CUDA stream on the CPU)."""
    monkeypatch.setattr(build, "stream_handle", lambda device: "stream")
    monkeypatch.setattr(build, "launches", collections.Counter())
    return build.launches


@pytest.mark.parametrize("status", [0, 700], ids=["ok", "error"])
def test_launch_counts_only_what_returned_no_error(counter, status):
    calls = []

    def fn(*args):
        calls.append(args)
        return status

    # Device -1: ``torch.cuda.device`` enters no device.
    if status:
        with pytest.raises(RuntimeError,
                           match=f"{NAME}: CUDA launch failed with error "
                                 f"{status}"):
            build.launch(NAME, fn, -1, 1, 2.5, None)
    else:
        build.launch(NAME, fn, -1, 1, 2.5, None)
    assert calls == [(1, 2.5, None, "stream")]
    assert counter == ({} if status else {NAME: 1})


def test_entry_binds_a_symbol_once_with_the_stream_last(monkeypatch):
    libc = ctypes.CDLL(None)
    monkeypatch.setattr(build, "load", lambda name: libc)
    build.entry.cache_clear()
    try:
        fn = build.entry("libc", "labs", ctypes.c_long)
        assert list(fn.argtypes) == [ctypes.c_long, ctypes.c_void_p]
        assert fn.restype is ctypes.c_int
        assert build.entry("libc", "labs", ctypes.c_long) is fn
    finally:
        build.entry.cache_clear()
