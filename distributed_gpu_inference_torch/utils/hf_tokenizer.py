"""Tokenizers from a local directory (``tokenizer.json`` and
``tokenizer_config.json``), with their chat templates.

The port's stand-in for what the JAX package's worker gets from
``transformers.AutoTokenizer.from_pretrained(local_dir)``
(``distributed_gpu_inference_tpu/worker/engines/llm.py``
``_load_hf_tokenizer``). The card's machine has no ``tokenizers``,
``transformers`` or ``regex``, so the pipeline is read from the JSON and run
here, for the BPE tokenizers of the families in ``models/configs.py``: the
byte-level ones (Llama 3, Qwen 2.5, GPT-2) and the SentencePiece-style ones
(Mistral, Mixtral); and for WordPiece (BERT's kind) and Unigram
(SentencePiece's unigram models, T5's kind) tokenizers:

- added tokens (``special``, ``lstrip``, ``rstrip``, ``single_word``,
  ``normalized``) are split out first, leftmost-longest, the unnormalized
  ones on the raw text and the normalized ones after the normalizer;
- normalizer: none, a Unicode normal form (NFC, ...), ``Prepend``,
  ``Replace``, ``Lowercase``, ``Strip``, ``Nmt``, ``BertNormalizer``
  (``clean_text``, ``handle_chinese_chars``, ``strip_accents``,
  ``lowercase``) or a ``Sequence`` of them. ``Precompiled`` (a
  SentencePiece charsmap, what converted ``spiece.model`` files carry) is
  refused by name: no file carrying one can be built offline to hold this
  reader to the library;
- pre-tokenizer: none, ``Split`` on a regex with the ``Isolated``
  behaviour, ``ByteLevel`` (with or without GPT-2's split regex),
  ``Metaspace`` (its ``prepend_scheme`` and ``split``), ``BertPreTokenizer``,
  ``Whitespace`` (``\\w+|[^\\w\\s]+``), ``WhitespaceSplit``,
  ``Punctuation`` (isolated or removed), or a ``Sequence``.
  The patterns use Oniguruma's ``\\p{L}`` / ``\\p{N}`` classes, which
  Python's ``re`` lacks: they are rebuilt from ``unicodedata`` as ``re``
  ranges, and ``\\s`` is spelled out as Unicode's White_Space set (Python's
  ``\\s`` also takes U+001C-U+001F, Oniguruma's does not);
- model: BPE, merges as ``"a b"`` strings or ``[a, b]`` pairs, the
  lowest-ranked adjacent pair merged first (leftmost among equals; a heap,
  so a SentencePiece-style section with no pre-tokenizer, one long word,
  merges in n log n), ``ignore_merges`` (a whole pre-token in the vocab is
  one id), ``byte_fallback`` (a character outside the vocab becomes its
  UTF-8 bytes' ``<0xXX>`` pieces) and ``unk_token`` with ``fuse_unk``;
  WordPiece, greedy longest-match-first with ``continuing_subword_prefix``,
  ``max_input_chars_per_word`` and ``unk_token`` (a word with a piece
  outside the vocab is one unknown token); Unigram, the best path under
  the piece scores (Viterbi over the characters, an unknown character
  scored ``min - 10`` and runs of them fused), its unknown pieces as
  ``<0xXX>`` bytes with ``byte_fallback``, else ``unk_id``;
- post-processor: ``TemplateProcessing`` (the BOS of Llama 3),
  ``BertProcessing`` (``[CLS] $A [SEP]``), ``ByteLevel`` (ids unchanged) or
  a ``Sequence``;
- decoder: ``ByteLevel``: added tokens are emitted as their text, outside
  the decoder, and each run of model tokens between them is decoded on its
  own, invalid UTF-8 becoming U+FFFD (the stream splicer holds a trailing
  U+FFFD back). Or a chain of ``Replace``, ``ByteFallback`` (a run of
  ``<0xXX>`` pieces decodes as UTF-8, an invalid run as one U+FFFD a
  byte), ``Fuse``, ``Strip``, ``Metaspace`` and ``WordPiece`` (the prefix
  joined, a space before every other token, its ``cleanup``) steps (a
  ``Sequence``), run
  as the ``tokenizers`` library runs them over every token, added ones
  included. ``clean_up_tokenization_spaces`` applies transformers'
  replacements.

``apply_chat_template`` renders the template as transformers does: a
sandboxed ``jinja2`` environment with ``trim_blocks`` and ``lstrip_blocks``,
loop controls, its ``tojson`` filter, ``raise_exception`` and
``strftime_now``, and the special tokens as variables. The template is
read from ``chat_template.jinja``, else from ``tokenizer_config.json``
(a string, or a list of ``{name, template}``). ``jinja2`` is imported when
a tokenizer with a template loads; without a template the call raises, as
transformers does.

Anything else (other models, normalizers, pre-tokenizers, post-processors
or decoders, and the ``Precompiled`` normalizer) is refused at load with
:class:`TokenizerUnsupported` naming the component.
"""

from __future__ import annotations

import bisect
import functools
import heapq
import json
import re
import unicodedata
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from distributed_gpu_inference_torch.utils import bert_chars


class TokenizerUnsupported(ValueError):
    """The directory's tokenizer uses a component this reader does not
    have."""


# Unicode's White_Space property: what Oniguruma's and Rust's \s and
# is_whitespace match (Python's re \s also takes U+001C-U+001F)
_WS_CLASS = (r"\t\n\x0b\x0c\r\x20\x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f"
             r"\u205f\u3000")
_WS = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                + "".join(map(chr, range(0x2000, 0x200B))))

# GPT-2's split pattern (ByteLevel with use_regex=true)
_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                 r"|\s+(?!\S)|\s+")

# transformers' clean_up_tokenization, in its order
_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
            (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
            (" 're", "'re"))

_SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                  "cls_token", "mask_token")


@functools.cache
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.cache
def _unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in _bytes_to_unicode().items()}


@functools.cache
def _category_class(name: str) -> str:
    """``re`` character-class ranges (no brackets) of the code points whose
    general category is ``name`` (``L``, ``N``) or starts with it."""
    ranges: List[Tuple[int, int]] = []
    for cp in range(0x110000):
        if unicodedata.category(chr(cp)).startswith(name):
            if ranges and ranges[-1][1] == cp - 1:
                ranges[-1] = (ranges[-1][0], cp)
            else:
                ranges.append((cp, cp))
    if not ranges:
        raise TokenizerUnsupported(f"unknown Unicode property \\p{{{name}}}")
    return "".join(f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}"
                   for lo, hi in ranges)


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern of a ``tokenizer.json`` → the same pattern for
    Python's ``re``: ``\\p{X}`` / ``\\P{X}`` become category ranges and
    ``\\s`` / ``\\S`` the White_Space set, inside and outside classes."""
    out: List[str] = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            e = pattern[i + 1]
            if e in "pP":
                m = re.match(r"\{\^?(\w+)\}", pattern[i + 2:])
                if not m:
                    raise TokenizerUnsupported(f"regex escape at {i} of {pattern!r}")
                rng = _category_class(m.group(1))
                negated = (e == "P") != m.group(0).startswith("{^")
                if in_class:
                    if negated:
                        raise TokenizerUnsupported(
                            f"a negated property inside a class in {pattern!r}")
                    out.append(rng)
                else:
                    out.append(f"[{'^' if negated else ''}{rng}]")
                i += 2 + len(m.group(0))
                continue
            if e in "sS":
                if in_class:
                    if e == "S":
                        raise TokenizerUnsupported(f"\\S inside a class in {pattern!r}")
                    out.append(_WS_CLASS)
                else:
                    out.append(f"[{'^' if e == 'S' else ''}{_WS_CLASS}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":       # a leading ] is a literal
                out.append("\\]")
                i += 1
            continue
        if c == "]" and in_class:
            in_class = False
        elif c == "[" and in_class:
            raise TokenizerUnsupported(f"a nested class in {pattern!r}")
        out.append(c)
        i += 1
    return "".join(out)


def _isolated_split(rx: "re.Pattern[str]", piece: str) -> List[str]:
    """``Split(..., behavior="Isolated")``: every match and every stretch
    between matches is a piece of its own."""
    out: List[str] = []
    last = 0
    for m in rx.finditer(piece):
        if m.start() > last:
            out.append(piece[last:m.start()])
        if m.end() > m.start():
            out.append(m.group(0))
        last = m.end()
    if last < len(piece):
        out.append(piece[last:])
    return out


def _replacer(spec: Dict[str, Any], what: str) -> Callable[[str], str]:
    """A ``Replace`` step's pattern (a ``String`` or a ``Regex``) and its
    ``content``, applied to every occurrence."""
    pat, content = spec.get("pattern") or {}, spec.get("content", "")
    if "String" in pat:
        return lambda s: s.replace(pat["String"], content)
    if "Regex" in pat:
        rx = re.compile(translate_pattern(pat["Regex"]))
        return lambda s: rx.sub(lambda m: content, s)
    raise TokenizerUnsupported(f"{what} Replace pattern {pat!r}")


def _lowercase(s: str) -> str:
    """Each character's own lower case (no context rule: a final capital
    sigma lowers to σ, as Rust's ``char::to_lowercase`` does), by the
    library's tables where they differ from Python's
    (``utils/bert_chars.py`` ``LOWER``)."""
    return "".join(bert_chars.LOWER.get(ord(c)) or c.lower() for c in s)


class _CodePoints:
    """Membership in a table of inclusive code-point ranges."""

    def __init__(self, ranges: Tuple[Tuple[int, int], ...]) -> None:
        self._lo = [lo for lo, _ in ranges]
        self._hi = [hi for _, hi in ranges]

    def __contains__(self, c: str) -> bool:
        i = bisect.bisect_right(self._lo, ord(c)) - 1
        return i >= 0 and ord(c) <= self._hi[i]


# the ``tokenizers`` library's BERT classes (its Unicode tables are older
# than the running Python's: a character assigned since, such as U+0C77,
# must stay inside a word as the library keeps it)
_PUNCT = _CodePoints(bert_chars.PUNCT)
_DROPPED = _CodePoints(bert_chars.DROPPED)
_MARK = _CodePoints(bert_chars.MARK)


def _strip_accents(s: str) -> str:
    """NFD, then the nonspacing marks (``Mn`` of the library's tables)
    dropped; a character whose decomposition the library's tables lack
    (``utils/bert_chars.py`` ``STRIP``) becomes the library's result."""
    out, start = [], 0
    for i, c in enumerate(s):
        if ord(c) in bert_chars.STRIP:
            out += [_nfd_unmarked(s[start:i]), bert_chars.STRIP[ord(c)]]
            start = i + 1
    out.append(_nfd_unmarked(s[start:]))
    return "".join(out)


def _nfd_unmarked(s: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", s) if c not in _MARK)


# the CJK blocks BERT spaces out (``tokenizers``' is_chinese_char)
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _bert_normalizer(spec: Dict[str, Any]) -> Callable[[str], str]:
    """``BertNormalizer``: ``clean_text`` drops NUL, U+FFFD and the
    control, format, private-use and surrogate characters of the library's
    tables (``utils/bert_chars.py``; tab, newline and carriage return kept,
    unassigned code points kept, as the library keeps them) and makes every
    White_Space character a
    space; ``handle_chinese_chars`` puts a space on each side of a CJK
    ideograph; ``strip_accents`` (default: as ``lowercase``) and
    ``lowercase``, in that order."""
    clean = spec.get("clean_text", True)
    chinese = spec.get("handle_chinese_chars", True)
    lower = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    strip = lower if strip is None else strip

    def run(s: str) -> str:
        if clean:
            s = "".join(" " if c in _WS else c for c in s if c not in _DROPPED)
        if chinese:
            s = "".join(f" {c} " if _is_cjk(c) else c for c in s)
        if strip:
            s = _strip_accents(s)
        return _lowercase(s) if lower else s

    return run


# ``Nmt``: the control characters it drops, and the characters it makes a space
_NMT_DROP = frozenset(chr(c) for c in (*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20),
                                       0x7F, 0x8F, 0x9F))
_NMT_SPACE = frozenset(chr(c) for c in (0x09, 0x0A, 0x0C, 0x0D, 0x1680,
                                        *range(0x200B, 0x2010), 0x2028, 0x2029,
                                        0x2581, 0xFEFF, 0xFFFD))


def _nmt(s: str) -> str:
    return "".join(" " if c in _NMT_SPACE else c for c in s if c not in _NMT_DROP)


def _strip_ws(spec: Dict[str, Any]) -> Callable[[str], str]:
    """``Strip``: White_Space off the left and / or the right."""
    left, right = spec.get("strip_left", True), spec.get("strip_right", True)
    ws = "".join(sorted(_WS))

    def run(s: str) -> str:
        if left:
            s = s.lstrip(ws)
        return s.rstrip(ws) if right else s

    return run


def _normalizer(spec: Optional[Dict[str, Any]]) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return functools.partial(unicodedata.normalize, kind)
    if kind == "Prepend":
        prefix = spec.get("prepend", "")
        return lambda s: prefix + s if s else s
    if kind == "Replace":
        return _replacer(spec, "normalizer")
    if kind == "Lowercase":
        return _lowercase
    if kind == "Strip":
        return _strip_ws(spec)
    if kind == "Nmt":
        return _nmt
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec.get("normalizers", [])]
        return functools.reduce(lambda f, g: (lambda s: g(f(s))), steps, lambda s: s)
    if kind == "Precompiled":
        raise TokenizerUnsupported(
            "normalizer 'Precompiled' (a SentencePiece charsmap): not read; no file "
            "carrying one can be built offline to hold this reader to the library")
    raise TokenizerUnsupported(f"normalizer {kind!r}")


# a pre-tokenizer step: (piece, whether the piece starts the original
# text) → its pieces
PreStep = Callable[[str, bool], List[str]]


def _prepend_scheme(spec: Dict[str, Any]) -> str:
    """A ``Metaspace`` step's ``prepend_scheme``; files older than the
    field carry ``add_prefix_space`` instead (true: ``always``)."""
    scheme = spec.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "first", "never"):
        raise TokenizerUnsupported(f"Metaspace prepend_scheme {scheme!r}")
    return scheme


def _metaspace(spec: Dict[str, Any]) -> PreStep:
    """``Metaspace``: spaces become the replacement; the replacement is
    prepended to a piece that does not start with it (``always``), or only
    to the piece that starts the text (``first``); with ``split`` the piece
    is cut before every replacement."""
    rep = spec.get("replacement", "\u2581")
    scheme = _prepend_scheme(spec)
    split = spec.get("split", True)

    def step(piece: str, at_start: bool) -> List[str]:
        piece = piece.replace(" ", rep)
        if (scheme == "always" or (scheme == "first" and at_start)) \
                and not piece.startswith(rep):
            piece = rep + piece
        if not split:
            return [piece]
        cuts = [i for i, c in enumerate(piece) if c == rep and i > 0]
        return [piece[a:b] for a, b in zip([0] + cuts, cuts + [len(piece)])]

    return step


def _is_punctuation(c: str) -> bool:
    """BERT's punctuation: ASCII punctuation (symbols such as ``$`` and
    ``+`` included) or a ``P*`` character of the library's Unicode tables
    (``utils/bert_chars.py``)."""
    return c in _PUNCT


def _split_ws(piece: str) -> List[str]:
    """Split on White_Space, the whitespace removed."""
    out, cur = [], []
    for c in piece:
        if c in _WS:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(c)
    if cur:
        out.append("".join(cur))
    return out


def _split_punct(piece: str, keep: bool = True) -> List[str]:
    """Each punctuation character its own piece (``keep``), or dropped."""
    out, cur = [], []
    for c in piece:
        if _is_punctuation(c):
            if cur:
                out.append("".join(cur))
                cur = []
            if keep:
                out.append(c)
        else:
            cur.append(c)
    if cur:
        out.append("".join(cur))
    return out


# the So characters of Unicode's Other_Alphabetic (circled and squared
# Latin letters) and the join controls: in Oniguruma's \w, not in a category
_ALPHA_SYMBOLS = (r"\u200c\u200d\u24b6-\u24e9\U0001f130-\U0001f149\U0001f150-\U0001f169"
                  r"\U0001f170-\U0001f189")


@functools.cache
def _whitespace_rx() -> "re.Pattern[str]":
    """``Whitespace``'s ``\\w+|[^\\w\\s]+`` with Oniguruma's Unicode ``\\w``
    (Alphabetic, marks, decimal digits, connector punctuation, the join
    controls: here letters, marks, ``Nd``, ``Nl``, ``Pc``, U+200C-U+200D and
    the circled / squared letters that are Alphabetic symbols) and ``\\s``."""
    w = "".join(_category_class(c) for c in ("L", "M", "Nd", "Nl", "Pc")) + _ALPHA_SYMBOLS
    return re.compile(f"[{w}]+|[^{w}{_WS_CLASS}]+")


def _pre_tokenizer(spec: Optional[Dict[str, Any]]) -> List[PreStep]:
    """The pre-tokenizer as a list of steps, each mapping one piece to its
    pieces; ByteLevel's last step maps the bytes to the BPE alphabet."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for s in spec.get("pretokenizers", []) for step in _pre_tokenizer(s)]
    if kind == "Split":
        if spec.get("behavior") != "Isolated" or spec.get("invert"):
            raise TokenizerUnsupported(
                f"Split behavior {spec.get('behavior')!r} (invert={spec.get('invert')})")
        pat = spec.get("pattern", {})
        if "Regex" not in pat:
            raise TokenizerUnsupported(f"Split pattern {pat!r} (a Regex is read)")
        rx = re.compile(translate_pattern(pat["Regex"]))
        return [lambda p, _: _isolated_split(rx, p)]
    if kind == "Metaspace":
        return [_metaspace(spec)]
    if kind == "BertPreTokenizer":
        return [lambda p, _: [q for w in _split_ws(p) for q in _split_punct(w)]]
    if kind == "WhitespaceSplit":
        return [lambda p, _: _split_ws(p)]
    if kind == "Whitespace":
        return [lambda p, _: _whitespace_rx().findall(p)]
    if kind == "Punctuation":
        behavior = spec.get("behavior", "Isolated")
        if behavior not in ("Isolated", "Removed"):
            raise TokenizerUnsupported(f"Punctuation behavior {behavior!r}")
        keep = behavior == "Isolated"
        return [lambda p, _: _split_punct(p, keep)]
    if kind == "ByteLevel":
        steps: List[PreStep] = []
        if spec.get("add_prefix_space"):
            steps.append(lambda p, _: [p if p.startswith(" ") else " " + p])
        if spec.get("use_regex", True):
            rx = re.compile(translate_pattern(_GPT2_PATTERN))
            steps.append(lambda p, _: _isolated_split(rx, p))
        table = _bytes_to_unicode()
        steps.append(lambda p, _: ["".join(table[b] for b in p.encode("utf-8"))])
        return steps
    raise TokenizerUnsupported(f"pre-tokenizer {kind!r}")


def _byte_piece(token: str) -> Optional[int]:
    """The byte of a ``<0xXX>`` piece, else None."""
    if len(token) == 6 and token.startswith("<0x") and token.endswith(">"):
        try:
            return int(token[3:5], 16)
        except ValueError:
            return None
    return None


def _byte_fallback(tokens: List[str]) -> List[str]:
    """``ByteFallback``: each run of ``<0xXX>`` pieces becomes its UTF-8
    text, or one U+FFFD a byte where the run is not valid UTF-8."""
    out: List[str] = []
    run = bytearray()

    def flush() -> None:
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" for _ in run)
            run.clear()

    for t in tokens:
        b = _byte_piece(t)
        if b is None:
            flush()
            out.append(t)
        else:
            run.append(b)
    flush()
    return out


def _strip(spec: Dict[str, Any]) -> Callable[[List[str]], List[str]]:
    """``Strip``: up to ``start`` leading and ``stop`` trailing ``content``
    characters off each token."""
    c, start, stop = spec.get("content", " "), int(spec.get("start", 0)), int(spec.get("stop", 0))

    def one(t: str) -> str:
        a = 0
        while a < min(start, len(t)) and t[a] == c:
            a += 1
        b, n = len(t), 0
        while n < stop and b > a and t[b - 1] == c:
            b -= 1
            n += 1
        return t[a:b]

    return lambda tokens: [one(t) for t in tokens]


def _metaspace_decode(spec: Dict[str, Any]) -> Callable[[List[str]], List[str]]:
    """``Metaspace`` decoding: the replacement becomes a space, except in
    the first token, where (unless the scheme is ``never``) every
    replacement is dropped."""
    rep = spec.get("replacement", "\u2581")
    drop_first = _prepend_scheme(spec) != "never"
    return lambda tokens: [t.replace(rep, "" if i == 0 and drop_first else " ")
                           for i, t in enumerate(tokens)]


# the WordPiece decoder's ``cleanup``, in its order
_WORDPIECE_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                      (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"),
                      (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))


def _wordpiece_decode(spec: Dict[str, Any]) -> Callable[[List[str]], List[str]]:
    """``WordPiece`` decoding: every token but the first loses a leading
    ``prefix`` or gains a leading space; ``cleanup`` then tidies each."""
    prefix, cleanup = spec.get("prefix", "##"), spec.get("cleanup", True)

    def one(i: int, t: str) -> str:
        if i:
            t = t.replace(prefix, "", 1) if t.startswith(prefix) else " " + t
        if cleanup:
            for a, b in _WORDPIECE_CLEANUP:
                t = t.replace(a, b)
        return t

    return lambda tokens: [one(i, t) for i, t in enumerate(tokens)]


def _decoder(spec: Dict[str, Any]) -> Callable[[List[str]], List[str]]:
    """A chain of decoders over the token strings, as the ``tokenizers``
    library's ``decode_chain``; ``ByteLevel`` is read only as the whole
    decoder (``HFTokenizer._byte_level_decode``)."""
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec.get("decoders", [])]
        return functools.reduce(lambda f, g: (lambda t: g(f(t))), steps, lambda t: t)
    if kind == "Replace":
        rep = _replacer(spec, "decoder")
        return lambda tokens: [rep(t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return _strip(spec)
    if kind == "Metaspace":
        return _metaspace_decode(spec)
    if kind == "WordPiece":
        return _wordpiece_decode(spec)
    raise TokenizerUnsupported(f"decoder {kind!r}")


def _post_processor(spec: Optional[Dict[str, Any]]) -> Callable[[List[int]], List[int]]:
    if spec is None:
        return lambda ids: ids
    kind = spec.get("type")
    if kind == "ByteLevel":          # offsets only: the ids are unchanged
        return lambda ids: ids
    if kind == "Sequence":
        steps = [_post_processor(s) for s in spec.get("processors", [])]
        return functools.reduce(lambda f, g: (lambda ids: g(f(ids))), steps,
                                lambda ids: ids)
    if kind == "BertProcessing":
        cls_id, sep_id = int(spec["cls"][1]), int(spec["sep"][1])
        return lambda ids: [cls_id] + list(ids) + [sep_id]
    if kind == "TemplateProcessing":
        specials = {k: list(v["ids"]) for k, v in spec.get("special_tokens", {}).items()}
        parts: List[Optional[List[int]]] = []
        for item in spec.get("single", []):
            if "SpecialToken" in item:
                parts.append(specials[item["SpecialToken"]["id"]])
            elif item.get("Sequence", {}).get("id") == "A":
                parts.append(None)
            else:
                raise TokenizerUnsupported(f"TemplateProcessing piece {item!r}")
        return lambda ids: [t for p in parts for t in (ids if p is None else p)]
    raise TokenizerUnsupported(f"post-processor {kind!r}")


def _token_text(value: Any) -> Optional[str]:
    """A special token of ``tokenizer_config.json``: a string, or an
    ``AddedToken`` dict with its ``content``."""
    if isinstance(value, dict):
        return value.get("content")
    return value if isinstance(value, str) else None


class _AddedToken:
    __slots__ = ("id", "content", "special", "lstrip", "rstrip", "single_word",
                 "normalized")

    def __init__(self, spec: Dict[str, Any]) -> None:
        self.id = int(spec["id"])
        self.content = spec["content"]
        self.special = bool(spec.get("special", False))
        self.lstrip = bool(spec.get("lstrip", False))
        self.rstrip = bool(spec.get("rstrip", False))
        self.single_word = bool(spec.get("single_word", False))
        self.normalized = bool(spec.get("normalized", not self.special))


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


# the score below the lowest piece's that an unknown character costs (the
# ``tokenizers`` library's and SentencePiece's K_UNK_PENALTY)
_UNK_PENALTY = 10.0


class HFTokenizer:
    """A BPE, WordPiece or Unigram tokenizer read from a local directory. The surface
    the LLM engine calls: :meth:`encode` (the post-processor's special
    tokens added, as transformers' default), :meth:`decode` (special tokens
    kept), :meth:`apply_chat_template`, ``eos_token_id``, ``bos_token_id``
    and ``vocab_size`` (the model's vocab without added tokens)."""

    def __init__(self, tokenizer: Dict[str, Any], config: Optional[Dict[str, Any]] = None,
                 chat_template: Any = None, name: str = "tokenizer") -> None:
        config = dict(config or {})
        self.name = name
        model = tokenizer.get("model") or {}
        self.model_type = model.get("type")
        if self.model_type not in ("BPE", "WordPiece", "Unigram"):
            raise TokenizerUnsupported(
                f"model {self.model_type!r} (BPE, WordPiece and Unigram are read)")
        if self.model_type == "BPE":
            for key in ("continuing_subword_prefix", "end_of_word_suffix"):
                if model.get(key):
                    raise TokenizerUnsupported(f"BPE {key}={model[key]!r}")
            if model.get("dropout"):
                raise TokenizerUnsupported(f"BPE dropout={model['dropout']}")
        decoder = tokenizer.get("decoder") or {}
        # None: the ByteLevel decode; else the decoder chain
        self._decode_chain = (None if decoder.get("type") == "ByteLevel"
                              else _decoder(decoder))

        if self.model_type == "Unigram":
            # [piece, score] pairs; a repeated piece keeps its last id
            pieces = [(str(t), float(sc)) for t, sc in model.get("vocab", [])]
            self.vocab: Dict[str, int] = {t: i for i, (t, _) in enumerate(pieces)}
            self.id_to_token: Dict[int, str] = {i: t for i, (t, _) in enumerate(pieces)}
            self._scores = [sc for _, sc in pieces]
            self._unk_score = min(self._scores, default=0.0) - _UNK_PENALTY
            self._unk_id = model.get("unk_id")
            self._max_piece = max((len(t) for t, _ in pieces), default=1)
        else:
            self.vocab = dict(model.get("vocab", {}))
            self.id_to_token = {i: t for t, i in self.vocab.items()}
        if self.model_type == "WordPiece":
            self._prefix = model.get("continuing_subword_prefix", "##")
            self._max_chars = int(model.get("max_input_chars_per_word", 100))
        self.vocab_size = len(self.vocab)
        self._ranks: Dict[Tuple[str, str], int] = {}
        for rank, merge in enumerate(model.get("merges", [])):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            if a + b not in self.vocab:
                raise ValueError(f"{name}: merge {a!r} {b!r} makes a token not in the vocab")
            self._ranks.setdefault((a, b), rank)
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self._unk = model.get("unk_token")
        self._cache: Dict[str, List[int]] = {}

        self.added = [_AddedToken(t) for t in tokenizer.get("added_tokens", [])]
        # the `tokenizers` library numbers added tokens itself: a token of
        # the vocab keeps its id, a new one takes the next id past the
        # vocab. An id in the file that disagrees would encode differently
        # here and there, so it is refused.
        next_id, seen = len(self.vocab), {}
        for t in self.added:
            want = self.vocab.get(t.content, seen.get(t.content))
            if want is None:
                want = seen[t.content] = next_id
                next_id += 1
            if t.id != want:
                raise ValueError(f"{name}: added token {t.content!r} has id {t.id}, but "
                                 f"its place in the vocab gives it {want}")
        self.added_by_id = {t.id: t for t in self.added}
        self.added_by_text = {t.content: t for t in self.added}
        self._added_rx = {
            norm: self._alternation([t for t in self.added if t.normalized == norm])
            for norm in (False, True)}

        self.normalize = _normalizer(tokenizer.get("normalizer"))
        pre = tokenizer.get("pre_tokenizer")
        # transformers resets a top-level add_prefix_space to the config's
        # (default False) when they differ (a Metaspace step's legacy field
        # is not in the state it reads)
        if isinstance(pre, dict) and "add_prefix_space" in pre \
                and pre.get("type") != "Metaspace":
            pre = dict(pre, add_prefix_space=bool(config.get("add_prefix_space", False)))
        self._pre = _pre_tokenizer(pre)
        self._post = _post_processor(tokenizer.get("post_processor"))

        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces",
                                                            False))
        self.special_tokens: Dict[str, Any] = {}
        for attr in _SPECIAL_ATTRS:
            text = _token_text(config.get(attr))
            if text:
                self.special_tokens[attr] = text
        extra = [_token_text(t) for t in config.get("additional_special_tokens") or []]
        if any(extra):
            self.special_tokens["additional_special_tokens"] = [t for t in extra if t]
        self.bos_token_id = self.token_to_id(self.special_tokens.get("bos_token"))
        self.eos_token_id = self.token_to_id(self.special_tokens.get("eos_token"))

        if isinstance(chat_template, list):
            chat_template = {t["name"]: t["template"] for t in chat_template}
        self.chat_template = chat_template
        self._compiled: Dict[str, Any] = {}
        if chat_template is not None:
            _jinja()       # a tokenizer with a template needs jinja2 to load

    @staticmethod
    def _alternation(tokens: Sequence[_AddedToken]) -> Optional["re.Pattern[str]"]:
        # longest first: re's leftmost-first alternation is then
        # leftmost-longest, as the added vocabulary's matcher
        texts = sorted({t.content for t in tokens if t.content}, key=len, reverse=True)
        return re.compile("|".join(map(re.escape, texts))) if texts else None

    @classmethod
    def from_dir(cls, path: str | Path) -> "HFTokenizer":
        p = Path(path)
        tok_file = p / "tokenizer.json"
        if not tok_file.is_file():
            raise FileNotFoundError(f"no tokenizer.json in {p}")
        tokenizer = json.loads(tok_file.read_text(encoding="utf-8"))
        cfg_file = p / "tokenizer_config.json"
        config = (json.loads(cfg_file.read_text(encoding="utf-8"))
                  if cfg_file.is_file() else {})
        legacy = p / "special_tokens_map.json"
        if legacy.is_file():
            for key, value in json.loads(legacy.read_text(encoding="utf-8")).items():
                config.setdefault(key, value)
        jinja_file = p / "chat_template.jinja"
        template = (jinja_file.read_text(encoding="utf-8") if jinja_file.is_file()
                    else config.get("chat_template"))
        return cls(tokenizer, config, template, name=str(p))

    def token_to_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        if token in self.added_by_text:
            return self.added_by_text[token].id
        return self.vocab.get(token)

    # -- encode ---------------------------------------------------------------

    def _split_added(self, text: str, normalized: bool
                     ) -> List[Tuple[Optional[int], str]]:
        """``text`` as (added token id or None, piece) in order: the
        added-vocabulary matcher with its lstrip / rstrip / single_word
        rules."""
        rx = self._added_rx[normalized]
        if rx is None or not text:
            return [(None, text)]
        out: List[Tuple[Optional[int], str]] = []
        start_offset = 0
        for m in rx.finditer(text):
            tok = self.added_by_text[m.group(0)]
            start, stop = m.start(), m.end()
            if tok.single_word and (
                    (start > 0 and _is_word_char(text[start - 1]))
                    or (stop < len(text) and _is_word_char(text[stop]))):
                continue
            if tok.lstrip:
                j = start
                while j > 0 and text[j - 1] in _WS:
                    j -= 1
                start = max(j, start_offset)
            if tok.rstrip:
                while stop < len(text) and text[stop] in _WS:
                    stop += 1
            if start_offset < start:
                out.append((None, text[start_offset:start]))
            out.append((tok.id, text[start:stop]))
            start_offset = stop
        if start_offset < len(text):
            out.append((None, text[start_offset:]))
        return out

    def _symbols(self, word: str) -> List[str]:
        """The word's starting symbols: each character in the vocab; else
        its bytes' ``<0xXX>`` pieces (``byte_fallback``, when all of them
        are in the vocab); else the unknown token, one for a run of
        unknown characters with ``fuse_unk``. As in the ``tokenizers``
        library, an unknown token waits until the next character in the
        vocab (or the word's end): byte pieces between pass it."""
        syms: List[str] = []
        unk = False           # an unknown token not yet placed
        for c in word:
            if c in self.vocab:
                if unk:
                    syms.append(self._unk)
                    unk = False
                syms.append(c)
                continue
            if self.byte_fallback:
                pieces = [f"<0x{b:02X}>" for b in c.encode("utf-8")]
                if all(p in self.vocab for p in pieces):
                    syms.extend(pieces)
                    continue
            if self._unk is not None:
                if unk and not self.fuse_unk:
                    syms.append(self._unk)
                unk = True
        if unk:
            syms.append(self._unk)
        return syms

    def _merge(self, syms: List[str]) -> List[str]:
        """Merge the lowest-ranked adjacent pair, leftmost among equals,
        until none is left: a heap of candidate pairs over a linked list
        of symbols, stale candidates skipped as they surface (the
        ``tokenizers`` library's order)."""
        n = len(syms)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        heap = [(r, i) for i in range(n - 1)
                if (r := self._ranks.get((syms[i], syms[i + 1]))) is not None]
        heapq.heapify(heap)
        while heap:
            rank, i = heapq.heappop(heap)
            j = nxt[i] if syms[i] is not None else -1
            if j < 0 or self._ranks.get((syms[i], syms[j])) != rank:
                continue
            syms[i] += syms[j]
            syms[j] = None
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            for a, b in ((prv[i], i), (i, nxt[i])):
                if a >= 0 and b >= 0:
                    r = self._ranks.get((syms[a], syms[b]))
                    if r is not None:
                        heapq.heappush(heap, (r, a))
        return [s for s in syms if s is not None]

    def _bpe(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids = [self.vocab[s] for s in self._merge(self._symbols(word)) if s in self.vocab]
        if len(self._cache) < 1 << 16 and len(word) < 256:
            self._cache[word] = ids
        return ids

    def _wordpiece(self, word: str) -> List[int]:
        """Greedy longest-match-first: the longest vocab piece at the start,
        then the longest ``prefix`` + piece from where it ended; a word
        longer than ``max_input_chars_per_word`` characters, or with a
        stretch no piece covers, is the one unknown token."""
        if not word:
            return []
        unk = [self.vocab[self._unk]] if self._unk in self.vocab else None
        if len(word) > self._max_chars:
            if unk is None:
                raise ValueError(f"{self.name}: WordPiece unk_token {self._unk!r} "
                                 "is not in the vocab")
            return unk
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 else self._prefix + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if start == end:
                if unk is None:
                    raise ValueError(f"{self.name}: WordPiece unk_token {self._unk!r} "
                                     "is not in the vocab")
                return unk
            start = end
        return ids

    def _unigram(self, word: str) -> List[int]:
        """The best-scoring segmentation (Viterbi over the characters, the
        ``tokenizers`` library's order of candidates and its strict ``>``
        for ties); a character no piece starts with costs the unknown
        score, and adjacent unknown stretches are fused into one, which
        becomes its bytes' ``<0xXX>`` pieces with ``byte_fallback`` (all
        of them in the vocab), else ``unk_id``."""
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        n = len(word)
        score = [0.0] * (n + 1)
        back: List[Optional[Tuple[int, Optional[int]]]] = [None] * (n + 1)
        for a in range(n):
            here = score[a]
            single = False
            for b in range(a + 1, min(n, a + self._max_piece) + 1):
                tid = self.vocab.get(word[a:b])
                if tid is None:
                    continue
                cand = self._scores[tid] + here
                if back[b] is None or cand > score[b]:
                    score[b], back[b] = cand, (a, tid)
                single = single or b == a + 1
            if not single:
                cand = self._unk_score + here
                if back[a + 1] is None or cand > score[a + 1]:
                    score[a + 1], back[a + 1] = cand, (a, None)
        pieces: List[Tuple[str, bool]] = []      # (text, unknown), last first
        end = n
        while end > 0:
            a, tid = back[end]
            unknown = tid is None or tid == self._unk_id
            if unknown and pieces and pieces[-1][1]:
                pieces[-1] = (word[a:end] + pieces[-1][0], True)
            else:
                pieces.append((word[a:end], unknown))
            end = a
        ids: List[int] = []
        for text, _ in reversed(pieces):
            tid = self.vocab.get(text)
            if tid is None:
                if self.byte_fallback:
                    bytes_ = [self.vocab.get(f"<0x{b:02X}>") for b in text.encode("utf-8")]
                    if all(t is not None for t in bytes_):
                        ids.extend(bytes_)
                        continue
                if self._unk_id is None:
                    raise ValueError(f"{self.name}: Unigram piece {text!r} is unknown and "
                                     "the model has no unk_id")
                tid = int(self._unk_id)
            ids.append(tid)
        if len(self._cache) < 1 << 16 and len(word) < 256:
            self._cache[word] = ids
        return ids

    def _model(self, word: str) -> List[int]:
        if self.model_type == "WordPiece":
            return self._wordpiece(word)
        if self.model_type == "Unigram":
            return self._unigram(word)
        return self._bpe(word)

    def _encode_piece(self, text: str, at_start: bool) -> List[int]:
        pieces = [(text, at_start)]
        for step in self._pre:
            pieces = [(q, first and j == 0) for p, first in pieces
                      for j, q in enumerate(step(p, first))]
        return [i for p, _ in pieces for i in self._model(p)]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        at = 0      # offset of the next raw piece in ``text``
        for tid, raw in self._split_added(text, normalized=False):
            raw_at, at = at, at + len(raw)
            if tid is not None:
                ids.append(tid)
                continue
            for j, (nid, piece) in enumerate(self._split_added(self.normalize(raw),
                                                               normalized=True)):
                if nid is not None:
                    ids.append(nid)
                elif piece:
                    ids.extend(self._encode_piece(piece, raw_at == 0 and j == 0))
        return self._post(ids) if add_special_tokens else ids

    # -- decode ---------------------------------------------------------------

    @staticmethod
    def _byte_level_decode(tokens: List[str]) -> str:
        table = _unicode_to_bytes()
        data = bytearray()
        for t in tokens:
            if all(c in table for c in t):
                data.extend(table[c] for c in t)
            else:
                data.extend(t.encode("utf-8"))
        return data.decode("utf-8", errors="replace")

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        if self._decode_chain is not None:
            return self._cleanup("".join(self._decode_chain(
                self._tokens(ids, skip_special_tokens))))
        out: List[str] = []
        chunk: List[str] = []
        for i in ids:
            i = int(i)
            added = self.added_by_id.get(i)
            if added is not None:
                out.append(self._byte_level_decode(chunk))
                chunk = []
                if not (skip_special_tokens and added.special):
                    out.append(added.content)
            elif i in self.id_to_token:
                chunk.append(self.id_to_token[i])
        out.append(self._byte_level_decode(chunk))
        return self._cleanup("".join(out))

    def _tokens(self, ids: Sequence[int], skip_special_tokens: bool) -> List[str]:
        """The ids' token strings, added tokens' as their text; ids past
        the vocab, and special tokens if asked, left out."""
        out: List[str] = []
        for i in ids:
            i = int(i)
            added = self.added_by_id.get(i)
            if added is not None:
                if not (skip_special_tokens and added.special):
                    out.append(added.content)
            elif i in self.id_to_token:
                out.append(self.id_to_token[i])
        return out

    def _cleanup(self, text: str) -> str:
        if self.clean_up_tokenization_spaces:
            for a, b in _CLEANUP:
                text = text.replace(a, b)
        return text

    # -- chat template ----------------------------------------------------------

    def _template(self) -> str:
        tmpl = self.chat_template
        if isinstance(tmpl, dict):
            if "default" not in tmpl:
                raise ValueError(
                    "This model has multiple chat templates with no default specified! "
                    f"Available template names are {sorted(tmpl)}.")
            return tmpl["default"]
        if tmpl is None:
            raise ValueError(
                "Cannot use chat template functions because tokenizer.chat_template is "
                f"not set ({self.name} has no chat template)")
        return tmpl

    def apply_chat_template(self, messages: List[Dict[str, Any]], tokenize: bool = False,
                            add_generation_prompt: bool = False, **kwargs: Any) -> Any:
        source = self._template()
        compiled = self._compiled.get(source)
        if compiled is None:
            compiled = self._compiled[source] = _jinja().from_string(source)
        text = compiled.render(messages=messages, tools=None, documents=None,
                               add_generation_prompt=add_generation_prompt,
                               **{**self.special_tokens, **kwargs})
        return self.encode(text, add_special_tokens=False) if tokenize else text


@functools.cache
def _jinja() -> Any:
    """transformers' chat-template environment (``jinja2`` is imported
    here, not with the module)."""
    try:
        import jinja2
        import jinja2.ext
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError as exc:
        raise TokenizerUnsupported(f"chat templates need jinja2: {exc}") from None

    def raise_exception(message: str) -> None:
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x: Any, ensure_ascii: bool = False, indent: Any = None,
               separators: Any = None, sort_keys: bool = False) -> str:
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True, extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = lambda fmt: datetime.now().strftime(fmt)
    return env
