"""Minimal dependency-free FITS binary-table writer/reader.

Standalone replacement for the astropy layer used by the reference's
scripts/Pinocchio2fits.py: catalogs, PLC and histories convert to FITS
BINTABLE extensions with self-describing parameter headers
(Pinocchio2fits.py:101-185).  Only what pinocchio outputs need is
implemented: primary HDU + BINTABLE extensions of numpy structured arrays.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

BLOCK = 2880

_TFORM = {"i2": "I", "i4": "J", "i8": "K", "u8": "K",
          "f4": "E", "f8": "D", "u4": "J"}


def _card(keyword: str, value=None, comment: str = "") -> bytes:
    kw = f"{keyword:<8s}"[:8]
    if value is None:
        out = kw + (" " * 2) + comment
    else:
        if isinstance(value, bool):
            v = f"{'T' if value else 'F':>20s}"
        elif isinstance(value, (int, np.integer)):
            v = f"{int(value):>20d}"
        elif isinstance(value, (float, np.floating)):
            v = f"{value:>20.12G}"
        else:
            v = f"'{str(value)[:67]:<8s}'"
            v = f"{v:<20s}"
        out = kw + "= " + v
        if comment:
            out += " / " + comment
    return out[:80].ljust(80).encode("ascii")


def _header(cards: List[bytes]) -> bytes:
    data = b"".join(cards) + _card("END")
    pad = (-len(data)) % BLOCK
    return data + b" " * pad


def _pad_data(data: bytes) -> bytes:
    return data + b"\x00" * ((-len(data)) % BLOCK)


def write_fits(path: str,
               tables: List[Tuple[str, np.ndarray, List[tuple]]],
               primary_cards: List[tuple] = None) -> str:
    """tables: list of (extname, structured array, extra header cards);
    extra cards are (keyword, value, comment) tuples."""
    with open(path, "wb") as fd:
        cards = [_card("SIMPLE", True, "conforms to FITS standard"),
                 _card("BITPIX", 8), _card("NAXIS", 0),
                 _card("EXTEND", True)]
        for c in (primary_cards or []):
            cards.append(_card(*c))
        fd.write(_header(cards))

        for extname, rec, extra in tables:
            rec = np.asarray(rec)
            names = rec.dtype.names
            # big-endian copy, flattening vector fields into repeat counts
            fields = []
            for nm in names:
                dt, _ = rec.dtype.fields[nm][:2]
                base = dt.base if dt.subdtype else dt
                count = int(np.prod(dt.shape)) if dt.shape else 1
                code = _TFORM[base.str[1:]]
                fields.append((nm, base, count, code))
            be_dtype = np.dtype([(nm, ">" + b.str[1:], (c,)) if c > 1
                                 else (nm, ">" + b.str[1:])
                                 for nm, b, c, _ in fields])
            be = np.zeros(len(rec), be_dtype)
            for nm in names:
                be[nm] = rec[nm]

            cards = [_card("XTENSION", "BINTABLE", "binary table"),
                     _card("BITPIX", 8), _card("NAXIS", 2),
                     _card("NAXIS1", be_dtype.itemsize,
                           "width of table in bytes"),
                     _card("NAXIS2", len(rec), "number of rows"),
                     _card("PCOUNT", 0), _card("GCOUNT", 1),
                     _card("TFIELDS", len(names))]
            for i, (nm, b, c, code) in enumerate(fields):
                cards.append(_card(f"TTYPE{i + 1}", nm))
                cards.append(_card(f"TFORM{i + 1}",
                                   (f"{c}{code}" if c > 1 else code)))
            cards.append(_card("EXTNAME", extname))
            for cdef in extra:
                cards.append(_card(*cdef))
            fd.write(_header(cards))
            fd.write(_pad_data(be.tobytes()))
    return path


def read_fits(path: str):
    """Parse the files written above (and standard simple BINTABLEs):
    returns list of (extname, header dict, structured array)."""
    out = []
    with open(path, "rb") as fd:
        raw = fd.read()
    pos = 0

    def parse_header(pos):
        cards = {}
        while True:
            block = raw[pos:pos + BLOCK]
            pos += BLOCK
            for i in range(0, BLOCK, 80):
                card = block[i:i + 80].decode("ascii", "replace")
                kw = card[:8].strip()
                if kw == "END":
                    return cards, pos
                if card[8:10] == "= ":
                    val = card[10:].split(" / ")[0].strip()
                    if val.startswith("'"):
                        cards[kw] = val.strip("'").strip()
                    elif val in ("T", "F"):
                        cards[kw] = val == "T"
                    else:
                        try:
                            cards[kw] = int(val)
                        except ValueError:
                            try:
                                cards[kw] = float(val)
                            except ValueError:
                                cards[kw] = val
            if pos >= len(raw):
                return cards, pos

    hdr, pos = parse_header(pos)       # primary
    while pos < len(raw):
        hdr, pos = parse_header(pos)
        if hdr.get("XTENSION", "").startswith("BINTABLE"):
            n1, n2 = hdr["NAXIS1"], hdr["NAXIS2"]
            nf = hdr["TFIELDS"]
            dts = []
            inv = {v: k for k, v in _TFORM.items()}
            for i in range(1, nf + 1):
                nm = hdr[f"TTYPE{i}"]
                tf = hdr[f"TFORM{i}"]
                cnt = int(tf[:-1]) if len(tf) > 1 else 1
                base = ">" + inv[tf[-1]]
                dts.append((nm, base, (cnt,)) if cnt > 1 else (nm, base))
            dt = np.dtype(dts)
            nbytes = n1 * n2
            rec = np.frombuffer(raw[pos:pos + nbytes], dt, n2)
            pos += nbytes + ((-nbytes) % BLOCK)
            out.append((hdr.get("EXTNAME", ""), hdr, rec))
        else:
            size = hdr.get("NAXIS1", 0) * hdr.get("NAXIS2", 0)
            pos += size + ((-size) % BLOCK) if size else 0
    return out


def _fits_path(src: str, outdir=None) -> str:
    """<dir>/<name>.out -> <outdir or dir>/<name>.fits."""
    import os
    out = src[:-3] + "fits"
    if outdir is not None:
        out = os.path.join(outdir, os.path.basename(out))
    return out


def convert_catalog_to_fits(catalog_path: str, params=None,
                            outdir=None) -> str:
    """pinocchio.<z>.<run>.catalog.out -> .fits (Pinocchio2fits.py analog),
    with the run parameters recorded in the header."""
    from .readers import read_catalog
    rec = read_catalog(catalog_path)
    extra = [("NHALOS", len(rec), "Number of halos in catalog")]
    if params is not None:
        import dataclasses
        for i, f in enumerate(dataclasses.fields(params)):
            v = getattr(params, f.name)
            if isinstance(v, (int, float, str, bool)):
                extra.append((f"PAR{i + 1}", f.name, ""))
                extra.append((f"VAL{i + 1}", v, ""))
    out = _fits_path(catalog_path, outdir)
    return write_fits(out, [("CATALOG", rec, extra)],
                      primary_cards=[("CODE", "pinocchio-jax", "")])


def convert_histories_to_fits(path: str, params=None, outdir=None) -> str:
    from .readers import read_histories
    ntrees, trees = read_histories(path)
    branches = np.concatenate(trees)
    ptr = np.zeros(ntrees, dtype=[("Nbranches", "<u4"),
                                  ("pointers", "<u4")])
    off = 0
    for i, t in enumerate(trees):
        ptr["Nbranches"][i] = len(t)
        ptr["pointers"][i] = off
        off += len(t)
    extra = [("NTREES", ntrees, "number of trees"),
             ("NBRANCH", len(branches), "number of branches")]
    out = _fits_path(path, outdir)
    return write_fits(out, [("HISTORIES", branches, extra),
                            ("POINTERS", ptr, extra)],
                      primary_cards=[("CODE", "pinocchio-jax", "")])
