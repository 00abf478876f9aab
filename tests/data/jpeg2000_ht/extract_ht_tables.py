"""Writes ``tsr_tpu_torch/native/ht_tables.h``: the two context VLC decode
tables of the HTJ2K cleanup pass (ITU-T T.814 | ISO/IEC 15444-15 Annex C),
read out of the libopenjp2 Pillow bundles (OpenJPEG 2.5's ht_dec.c,
``vlc_tbl0`` then ``vlc_tbl1``) or any other binary that holds them.

They are found by their field rules, not at a fixed offset: 2048
consecutive little-endian uint16 entries, each a codeword length of 1 to 7
bits (bits 0-2), ``u_off`` (bit 3), ``rho`` (bits 4-7), ``e_1`` (bits 8-11)
and ``e_k`` (bits 12-15) with ``e_1`` within ``e_k`` within ``rho``; each
table's 1024 entries indexed by context << 7 | the next 7 bits of the VLC
stream, so that every codeword of length L fills 2^(7 - L) entries alike.
Exactly one such run must exist. The port reads no binary at run time: the
header is committed. Run from the root of the checkout: ``python
tests/data/jpeg2000_ht/extract_ht_tables.py [binary]``.
"""

import glob
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[3]
HEADER = ROOT / "tsr_tpu_torch" / "native" / "ht_tables.h"


def pillow_libopenjp2():
    import PIL
    libs = glob.glob(str(Path(PIL.__file__).resolve().parents[1]
                         / "pillow.libs" / "libopenjp2-*.so*"))
    assert libs, "Pillow bundles no libopenjp2"
    return Path(libs[0])


def _valid(words):
    length, rho = words & 7, (words >> 4) & 15
    e1, ek = (words >> 8) & 15, (words >> 12) & 15
    return (length >= 1) & ((e1 & ~ek) == 0) & ((ek & ~rho) == 0)


def _consistent(table):
    """Every codeword of length L fills the 2^(7 - L) entries whose low L
    bits it is, each with the same entry."""
    for i, e in enumerate(table):
        step = 1 << int(e & 7)
        if any(table[j] != e for j in range((i & ~127) | (i & (step - 1)),
                                             (i & ~127) + 128, step)):
            return False
    return True


def find_tables(data: bytes):
    """(vlc_tbl0, vlc_tbl1) as two uint16 arrays of 1024 entries: the one
    run of 2048 valid entries, at either byte parity, whose halves are
    consistent tables."""
    found = []
    buf = np.frombuffer(data, np.uint8)
    for parity in (0, 1):
        n = (len(buf) - parity) // 2
        words = buf[parity:parity + 2 * n].view("<u2")
        ok = np.concatenate([[0], _valid(words).astype(np.int8), [0]])
        edges = np.diff(ok)
        for a, b in zip(np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)):
            for s in range(a, b - 2047):
                t = words[s:s + 2048]
                if _consistent(t[:1024]) and _consistent(t[1024:]):
                    found.append((parity + 2 * s, t.copy()))
    assert len(found) == 1, [hex(o) for o, _ in found]
    return found[0][1][:1024], found[0][1][1024:]


def header_text(tbl0, tbl1):
    def rows(t):
        return "\n".join("    " + ", ".join(f"0x{v:04x}" for v in t[i:i + 8])
                         + "," for i in range(0, len(t), 8))
    return f"""\
// ht_tables.h: the context VLC decode tables of the HTJ2K cleanup pass
// (ITU-T T.814 | ISO/IEC 15444-15, Annex C), as OpenJPEG 2.5's ht_dec.c
// holds them (BSD 2-clause licence; its HT block decoder comes from Aous
// Naman's OpenJPH): kHtVlc0 for the quads of a code-block's first row
// pair, kHtVlc1 for the others. Each is indexed by the quad's context
// (0-7) << 7 | the next 7 bits of the VLC stream; an entry packs the
// codeword's length (bits 0-2), u_off (bit 3), rho (bits 4-7), e_1
// (bits 8-11) and e_k (bits 12-15). Written by
// tests/data/jpeg2000_ht/extract_ht_tables.py from the tables' bytes in
// the libopenjp2 Pillow bundles (the same bytes stand in cv2's library).

#ifndef TSRIO_HT_TABLES_H_
#define TSRIO_HT_TABLES_H_

#include <cstdint>

namespace tsrio {{

constexpr uint16_t kHtVlc0[1024] = {{
{rows(tbl0)}
}};

constexpr uint16_t kHtVlc1[1024] = {{
{rows(tbl1)}
}};

}}  // namespace tsrio

#endif  // TSRIO_HT_TABLES_H_
"""


def main(argv):
    src = Path(argv[1]) if len(argv) > 1 else pillow_libopenjp2()
    tbl0, tbl1 = find_tables(src.read_bytes())
    HEADER.write_text(header_text(tbl0, tbl1))
    print(f"{HEADER}: {len(tbl0) + len(tbl1)} entries from {src}")


if __name__ == "__main__":
    main(sys.argv)
