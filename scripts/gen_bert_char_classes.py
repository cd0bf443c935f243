#!/usr/bin/env python3
"""Derive the ``tokenizers`` library's BERT character classes and write
them as ``distributed_gpu_inference_torch/utils/bert_chars.py``.

    python scripts/gen_bert_char_classes.py

The port's BERT normalizer and BERT / Punctuation pre-tokenizers
(``utils/hf_tokenizer.py``) hold these tables instead of the running
Python's ``unicodedata``, whose Unicode version is newer than the
library's: with it, a character assigned since (U+0C77, punctuation since
Unicode 12) split where the library keeps it inside a word. Each class is
read from the library's own behaviour on every code point but the
surrogates (one long probe string a pass, each code point between two
letters):

- ``PUNCT``: a piece of its own under ``BertPreTokenizer`` (the library's
  ``is_punctuation``, ASCII punctuation included);
- ``DROPPED``: removed by ``BertNormalizer``'s ``clean_text`` (its
  control, format and private-use classes, NUL and U+FFFD), and the
  surrogates;
- ``MARK``: removed by ``strip_accents`` when it stands alone after NFD
  (the nonspacing marks, ``Mn``, the accent strip drops);
- ``STRIP``: the code points whose ``strip_accents`` result differs from
  the running Python's NFD less ``MARK`` (decompositions the library's
  tables lack), mapped to the library's result;
- ``LOWER``: the code points whose ``Lowercase`` result differs from the
  running Python's ``str.lower`` (here the library's tables are the newer),
  mapped to the library's result.

``STRIP`` and ``LOWER`` are relative to the generating Python's
``unicodedata`` (its version is written in the table): run it with the
Python the port runs under.

It needs ``tokenizers`` (not on the card's machine, and not imported by
the port); the port reads only the written table.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import unicodedata

import tokenizers
from tokenizers import normalizers, pre_tokenizers

OUT = Path(__file__).resolve().parents[1] / "distributed_gpu_inference_torch" / "utils" / \
    "bert_chars.py"
SURROGATES = range(0xD800, 0xE000)
SEP = "a"


def code_points() -> List[int]:
    return [cp for cp in range(0x110000) if cp not in SURROGATES]


def probe(cps: Iterable[int]) -> str:
    """Each code point between two letters: ``a c a d a ...``."""
    return SEP + "".join(chr(cp) + SEP for cp in cps)


def punctuation(cps: List[int]) -> List[int]:
    pieces = pre_tokenizers.BertPreTokenizer().pre_tokenize_str(probe(cps))
    alone = {start for piece, (start, end) in pieces if end - start == 1 and piece != SEP}
    # code point i sits at offset 2i + 1 of the probe
    return [cp for i, cp in enumerate(cps) if 2 * i + 1 in alone]


def dropped_alone(norm, cps: List[int]) -> List[int]:
    """The code points ``norm`` removes when each stands alone."""
    out = []
    step = 4096
    for i0 in range(0, len(cps), step):
        chunk = cps[i0:i0 + step]
        for cp in chunk:
            if norm.normalize_str(chr(cp)) == "":
                out.append(cp)
    return out


def ranges(cps: List[int]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for cp in cps:
        if out and out[-1][1] == cp - 1:
            out[-1] = (out[-1][0], cp)
        else:
            out.append((cp, cp))
    return out


def fmt(name: str, rs: List[Tuple[int, int]]) -> str:
    body = "".join(f"    (0x{lo:04X}, 0x{hi:04X}),\n" for lo, hi in rs)
    return f"{name} = (\n{body})\n"


def fmt_map(name: str, m: Dict[int, str]) -> str:
    body = "".join(f"    0x{cp:04X}: {ascii(m[cp])},\n" for cp in sorted(m))
    return f"{name} = {{\n{body}}}\n"


def exceptions(norm, ours, cps: List[int]) -> Dict[int, str]:
    """The code points whose ``norm`` result alone differs from ``ours``."""
    out = {}
    for cp in cps:
        want = norm.normalize_str(chr(cp))
        if want != ours(chr(cp)):
            out[cp] = want
    return out


def main() -> int:
    cps = code_points()
    punct = punctuation(cps)
    clean = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=False,
                                       strip_accents=False, lowercase=False)
    strip = normalizers.BertNormalizer(clean_text=False, handle_chinese_chars=False,
                                       strip_accents=True, lowercase=False)
    # a lone surrogate reaches no Rust string; a Python one is dropped as
    # the control classes are (Cs)
    dropped = sorted(dropped_alone(clean, cps) + list(SURROGATES))
    marks = dropped_alone(strip, cps)
    mark_set = set(marks)
    strip_map = exceptions(strip, lambda c: "".join(
        x for x in unicodedata.normalize("NFD", c) if ord(x) not in mark_set), cps)
    lower_map = exceptions(normalizers.Lowercase(), str.lower, cps)
    text = (
        '"""The ``tokenizers`` library\'s BERT character classes, as inclusive\n'
        "code-point ranges: written by ``scripts/gen_bert_char_classes.py`` from\n"
        f"tokenizers {tokenizers.__version__}; do not edit. ``PUNCT``: a piece of its own\n"
        "under ``BertPreTokenizer``; ``DROPPED``: removed by ``BertNormalizer``'s\n"
        "``clean_text``; ``MARK``: removed by ``strip_accents`` standing alone;\n"
        "``STRIP`` / ``LOWER``: where the library's ``strip_accents`` / ``Lowercase``\n"
        f"differ from Python's NFD / ``str.lower`` (Unicode {unicodedata.unidata_version}),\n"
        "the library's result (``utils/hf_tokenizer.py`` reads them).\"\"\"\n\n"
        + fmt("PUNCT", ranges(punct)) + "\n" + fmt("DROPPED", ranges(dropped)) + "\n"
        + fmt("MARK", ranges(marks)) + "\n" + fmt_map("STRIP", strip_map) + "\n"
        + fmt_map("LOWER", lower_map)
    )
    OUT.write_text(text)
    print(f"{OUT}: PUNCT {len(punct)}, DROPPED {len(dropped)}, MARK {len(marks)} code points, "
          f"STRIP {len(strip_map)}, LOWER {len(lower_map)} exceptions (tokenizers "
          f"{tokenizers.__version__}, Python's Unicode {unicodedata.unidata_version})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
