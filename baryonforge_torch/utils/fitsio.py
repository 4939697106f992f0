"""Minimal FITS reader/writer for HEALPix maps (the port's copy of
``baryonforge_tpu.utils.fitsio``: pure numpy, so the two read each other's
files).

The reference loads shells with ``healpy.read_map(path)``
(reference utils/io.py:341-363); neither healpy nor astropy is a
dependency here, so this module speaks just enough FITS to round-trip the
standard HEALPix map serialization: a primary HDU with no data followed by
one BINTABLE extension whose column(s) hold the map in row-chunks
(healpy writes 1024-wide 'E' columns), with NSIDE/ORDERING keywords.

Only RING ordering is accepted (NESTED input raises — the framework is
ring-ordered throughout, matching the reference's default
``hp.read_map(..., nest=False)``).
"""

import numpy as np

__all__ = ["read_healpix_fits", "write_healpix_fits"]

_BLOCK = 2880

# FITS binary-table type codes -> numpy dtypes (big-endian on disk)
_TFORM = {"L": ">i1", "B": ">u1", "I": ">i2", "J": ">i4", "K": ">i8",
          "E": ">f4", "D": ">f8"}


def _read_header(fh):
    """Read one FITS header (2880-byte blocks of 80-char cards)."""
    cards = {}
    while True:
        block = fh.read(_BLOCK)
        if len(block) < _BLOCK:
            raise ValueError("truncated FITS header")
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return cards
            if "=" not in card[8:10]:
                continue
            val = card[10:].split("/")[0].strip()
            if val.startswith("'"):
                val = val[1:val.index("'", 1)].strip()
            elif val in ("T", "F"):
                val = (val == "T")
            else:
                try:
                    val = int(val)
                except ValueError:
                    try:
                        val = float(val)
                    except ValueError:
                        pass
            cards[key] = val


def _skip_data(fh, cards):
    bitpix = abs(int(cards.get("BITPIX", 8)))
    naxes = [int(cards.get(f"NAXIS{i + 1}", 0))
             for i in range(int(cards.get("NAXIS", 0)))]
    nbytes = (bitpix // 8) * int(np.prod(naxes)) if naxes else 0
    fh.seek((nbytes + _BLOCK - 1) // _BLOCK * _BLOCK, 1)


def read_healpix_fits(path, field=0):
    """Read a HEALPix map from FITS (healpy.read_map work-alike).

    Returns a float64 numpy array in RING ordering. ``field`` selects the
    table column for multi-column maps (e.g. IQU)."""
    with open(path, "rb") as fh:
        cards = _read_header(fh)             # primary HDU
        _skip_data(fh, cards)
        while True:
            cards = _read_header(fh)         # extension HDU
            if cards.get("XTENSION", "").startswith("BINTABLE"):
                break
            _skip_data(fh, cards)

        ordering = str(cards.get("ORDERING", "RING")).upper()
        if ordering.startswith("NEST"):
            raise NotImplementedError(
                "NESTED-ordered FITS maps are not supported; convert to "
                "RING ordering first")
        n_rows = int(cards["NAXIS2"])
        row_bytes = int(cards["NAXIS1"])
        n_cols = int(cards["TFIELDS"])
        dtypes, widths = [], []
        for c in range(1, n_cols + 1):
            tform = str(cards[f"TFORM{c}"]).strip()
            rep = "".join(ch for ch in tform if ch.isdigit())
            code = tform[len(rep):][:1]
            if code not in _TFORM:
                raise ValueError(f"unsupported TFORM {tform!r}")
            widths.append(int(rep) if rep else 1)
            dtypes.append(_TFORM[code])
        raw = fh.read(n_rows * row_bytes)
        if len(raw) < n_rows * row_bytes:
            raise ValueError("truncated FITS data")

    rec = np.frombuffer(raw, dtype=[(f"c{i}", dt, (w,)) for i, (dt, w)
                                    in enumerate(zip(dtypes, widths))],
                        count=n_rows)
    data = rec[f"c{field}"].astype(np.float64).ravel()
    nside = cards.get("NSIDE")
    if nside is not None:
        npix = 12 * int(nside) * int(nside)
        data = data[:npix]
        if data.size != npix:
            raise ValueError(f"map has {data.size} values, NSIDE={nside} "
                             f"needs {npix}")
    return data


def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        s = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        s = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        s = f"{key:<8}= {value:>20.12G}"
    else:
        s = f"{key:<8}= '{value:<8}'"
    if comment:
        s += f" / {comment}"
    return s[:80].ljust(80).encode("ascii")


def _pad(b):
    return b + b"\x00" * ((-len(b)) % _BLOCK)


def _header_block(cards):
    h = b"".join(cards) + b"END".ljust(80)
    return h + b" " * ((-len(h)) % _BLOCK)


def write_healpix_fits(path, hmap, dtype=">f4"):
    """Write a RING-ordered HEALPix map as a standard FITS BINTABLE
    (one 'SIGNAL' column, 1024-wide rows like healpy)."""
    hmap = np.asarray(hmap, dtype=np.float64)
    npix = hmap.size
    nside = int(np.sqrt(npix / 12))
    if 12 * nside * nside != npix:
        raise ValueError(f"{npix} is not a valid HEALPix map size")
    width = 1024 if npix % 1024 == 0 else 1
    n_rows = npix // width
    itemsize = np.dtype(dtype).itemsize

    primary = _header_block([
        _card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0),
        _card("EXTEND", True)])
    code = {4: "E", 8: "D"}[itemsize]
    ext = _header_block([
        _card("XTENSION", "BINTABLE"), _card("BITPIX", 8),
        _card("NAXIS", 2), _card("NAXIS1", width * itemsize),
        _card("NAXIS2", n_rows), _card("PCOUNT", 0), _card("GCOUNT", 1),
        _card("TFIELDS", 1), _card("TTYPE1", "SIGNAL"),
        _card("TFORM1", f"{width}{code}"),
        _card("PIXTYPE", "HEALPIX"), _card("ORDERING", "RING"),
        _card("NSIDE", nside), _card("FIRSTPIX", 0),
        _card("LASTPIX", npix - 1)])
    data = _pad(hmap.astype(dtype).tobytes())
    with open(path, "wb") as fh:
        fh.write(primary)
        fh.write(ext)
        fh.write(data)
