"""The CUDA launchers' C signatures against the ctypes argument types their
wrappers bind them with, and the build's source hash (CPU only: no nvcc).

ctypes passes each argument as ``_build.ARGTYPES`` says: a pointer or the
stream must be ``c_void_p``, an ``int`` ``c_int``, a ``float`` ``c_float``
and a ``long long`` ``c_longlong``.  A mismatch would cut a pointer to 32
bits or shift every later argument on the card, with no error at the call.
"""
import ctypes
import re
import shutil

import pytest

from repro_torch.kernels import _build

KINDS = {"int": ctypes.c_int, "float": ctypes.c_float,
         "long long": ctypes.c_longlong}


def launcher_params(name):
    """The parameter declarations of ``<name>_launch`` in ``<name>.cu``."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern\s+"C"\s+cudaError_t\s+' + name
                  + r"_launch\s*\(([^)]*)\)", text)
    assert m, f"no extern \"C\" {name}_launch in {name}.cu"
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def ctype_of(decl: str):
    """The ctypes type a C parameter declaration must be bound with."""
    if "*" in decl:
        return ctypes.c_void_p
    words = [w for w in decl.split()[:-1] if w != "const"]
    return KINDS[" ".join(words)]


@pytest.mark.parametrize("decl,kind", [
    ("const void* q", ctypes.c_void_p), ("void* stream", ctypes.c_void_p),
    ("int B", ctypes.c_int), ("float cap", ctypes.c_float),
    ("long long q_sb", ctypes.c_longlong)])
def test_declarations_map_to_ctypes(decl, kind):
    assert ctype_of(decl) is kind


@pytest.mark.parametrize("name", _build.SOURCES)
def test_source_exists(name):
    assert (_build.CSRC / f"{name}.cu").is_file()


def test_every_source_is_built():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) \
        == sorted(_build.SOURCES)


@pytest.mark.parametrize("name", _build.SOURCES)
def test_launcher_signature_matches_argtypes(name):
    params = launcher_params(name)
    kinds = [ctype_of(p) for p in params]
    assert len(kinds) == len(_build.ARGTYPES[name]), params
    for i, (decl, want, got) in enumerate(zip(params, kinds,
                                              _build.ARGTYPES[name])):
        assert got is want, f"{name}_launch argument {i} ({decl})"


@pytest.mark.parametrize("name", _build.SOURCES)
def test_digest_follows_every_header_and_the_source(name, tmp_path,
                                                    monkeypatch):
    """Editing any *.cuh or the source itself rebuilds the library; editing
    another source does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._digest(name)
    assert _build._digest(name) == before
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    for h in headers + [csrc / f"{name}.cu"]:
        h.write_text(h.read_text() + "\n// edited\n")
        after = _build._digest(name)
        assert after != before, h.name
        assert _build.lib_path(name).name == f"{name}-{after}.so"
        before = after
    for other in _build.SOURCES:
        if other != name:
            p = csrc / f"{other}.cu"
            p.write_text(p.read_text() + "\n// edited\n")
    assert _build._digest(name) == before


@pytest.mark.parametrize("n_slots,page,hd,dtype,want", [
    (220, 16, 64, "bfloat16", 28),     # the main path: 8 entries a split
    (80, 16, 64, "bfloat16", 10),      # the same rows, fewer entries
    (220, 1, 64, "float32", 2),        # 128 entries a split
    (220, 17, 128, "bfloat16", 32),    # 7 entries, 119 keys a split
    (220, 32, 128, "float32", 110),    # rows of 512 bytes: 64 keys
    (0, 16, 64, "bfloat16", 1),        # no entries: one empty split
])
def test_decode_splits(n_slots, page, hd, dtype, want):
    import torch
    from repro_torch.kernels import paged_attention as PA
    assert PA.decode_splits(n_slots, page, hd, getattr(torch, dtype)) == want


def test_decode_split_keys_match_the_source():
    """The wrapper sizes the splits' scratch with the kernel's own split
    size; the launcher refuses any other count of splits."""
    from repro_torch.kernels import paged_attention as PA
    text = (_build.CSRC / "paged_decode.cu").read_text()
    consts = dict(re.findall(r"constexpr int (SPLIT_KEYS\w*) = (\d+);", text))
    assert consts == {"SPLIT_KEYS": str(PA.SPLIT_KEYS),
                      "SPLIT_KEYS_WIDE": str(PA.SPLIT_KEYS_WIDE)}
    assert "sizeof(T) * HD > 256 ? SPLIT_KEYS_WIDE : SPLIT_KEYS" in text


def test_decode_counters_are_one_zeroed_buffer_a_device():
    """The decode kernel's finished-split counters: int32 zeros, at least
    one per (row, KV head), kept across calls and grown when a batch needs
    more."""
    import torch
    from repro_torch.kernels import paged_attention as PA
    dev = torch.device("cpu")
    PA._COUNTERS.pop(dev, None)
    a = PA._counters(dev, 16)
    assert a.dtype == torch.int32 and a.numel() >= 16
    assert not bool(a.any())
    assert PA._counters(dev, 8) is a
    b = PA._counters(dev, a.numel() + 1)
    assert b.numel() > a.numel() and not bool(b.any())
    assert PA._counters(dev, 8) is b
    PA._COUNTERS.pop(dev, None)
