"""Text analysis: tokenizer + filters, and text extraction.

TPU-native replacement for the reference's analysis chain, which is all
library calls inside the worker:

* Lucene ``StandardAnalyzer`` — used for both indexing and query parsing
  (``Worker.java:71-73``, ``Worker.java:226-227``). Lucene 9's
  ``StandardAnalyzer`` is ``StandardTokenizer`` (Unicode UAX#29 word
  boundaries) + ``LowerCaseFilter``, with an EMPTY default stopword set and
  a 255-char max token length. We reproduce that chain closely enough for
  top-k parity: alphanumeric runs with UAX#29's MidLetter apostrophe rule
  ("can't" is one token) and MidNum rule ("3.14" is one token).
* Apache Tika ``AutoDetectParser`` — the reference's fallback for non-UTF-8
  bytes (``Worker.java:198-212``). Reproduced as magic-byte dispatch with
  minimal pure-Python extractors (PDF ``Tj/TJ`` operators including
  CID/ToUnicode-encoded text, DOCX ``word/document.xml``, PPTX slide
  ``<a:t>`` runs, XLSX shared/inline strings, ODT ``content.xml``, RTF
  group-tree walking, HTML tag stripping), charset
  fallback for plain text, and a typed :class:`UnsupportedMediaType`
  rejection for binaries — an upload is extracted or refused, never
  indexed as mojibake.

The pure-Python tokenizer is the portable baseline implementation (a C++
fast path for the ingest hot loop is planned under ``native/``).
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import Iterable

# UAX#29-approximation:
#   - a token is a run of word characters (letters/digits/underscore —
#     underscore is ExtendNumLet in UAX#29, so "foo_bar" is one token);
#   - ' or ’ between letters does not break ("can't");
#   - . or , between digits does not break ("3.14", "1,000").
_TOKEN_RE = re.compile(r"\d+(?:[.,]\d+)*|\w+(?:['’]\w+)*", re.UNICODE)


@dataclass(frozen=True)
class Analyzer:
    """StandardAnalyzer-compatible chain: tokenize -> lowercase -> stop -> cap.

    Defaults mirror Lucene 9 ``StandardAnalyzer()``: lowercase on, no
    stopwords, ``maxTokenLength=255`` (overlong runs are *split*, like
    StandardTokenizer, not dropped).
    """

    lowercase: bool = True
    stopwords: frozenset[str] = frozenset()
    max_token_length: int = 255

    def tokens(self, text: str) -> list[str]:
        out: list[str] = []
        lower = self.lowercase
        cap = self.max_token_length
        stop = self.stopwords
        for m in _TOKEN_RE.finditer(text):
            tok = m.group()
            if lower:
                tok = tok.lower()
            if len(tok) > cap:
                # StandardTokenizer splits tokens longer than maxTokenLength
                for i in range(0, len(tok), cap):
                    piece = tok[i:i + cap]
                    if piece and piece not in stop:
                        out.append(piece)
                continue
            if tok in stop:
                continue
            out.append(tok)
        return out

    def counts(self, text: str) -> dict[str, int]:
        """Term -> frequency for one document (the per-doc TF map)."""
        freqs: dict[str, int] = {}
        for tok in self.tokens(text):
            freqs[tok] = freqs.get(tok, 0) + 1
        return freqs


def make_analyzer(lowercase: bool = True,
                  stopwords: Iterable[str] = (),
                  max_token_length: int = 255) -> Analyzer:
    return Analyzer(lowercase=lowercase,
                    stopwords=frozenset(stopwords),
                    max_token_length=max_token_length)


# --- text extraction (the Tika role) -------------------------------------
#
# The reference routes non-UTF-8 bytes through Tika's AutoDetectParser
# (Worker.java:198-212): PDFs/DOCX become searchable text, binaries fail
# loudly. This section reproduces that CONTRACT with a pure-Python pass:
# magic-byte detection, minimal PDF/DOCX/HTML extractors for the common
# formats, charset fallback for plain text, and a typed rejection for
# everything else — a binary is never silently indexed as mojibake.


class UnsupportedMediaType(ValueError):
    """Raised when document bytes are a binary format no extractor
    covers; the HTTP layer maps this to 415 Unsupported Media Type."""


_PDF_ESCAPES = {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b" ",
                b"f": b" ", b"(": b"(", b")": b")", b"\\": b"\\"}


def _pdf_unescape_bytes(raw: bytes) -> bytes:
    """Literal-string escapes -> raw string bytes (encoding-agnostic:
    the bytes may be Latin-1 text OR 2-byte CID codes)."""
    out = []
    i = 0
    while i < len(raw):
        c = raw[i:i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1:i + 2]
            if nxt.isdigit():                    # octal escape \ddd
                j = i + 1
                while j < min(i + 4, len(raw)) and raw[j:j + 1].isdigit():
                    j += 1
                try:
                    out.append(bytes([int(raw[i + 1:j], 8) & 0xFF]))
                except ValueError:
                    pass
                i = j
                continue
            out.append(_PDF_ESCAPES.get(nxt, nxt))
            i += 2
            continue
        out.append(c)
        i += 1
    return b"".join(out)


def _utf16be_hex(h: str) -> str:
    """ToUnicode destination hex -> text (UTF-16BE code units)."""
    if len(h) % 2:
        h = "0" + h
    return bytes.fromhex(h).decode("utf-16-be", "ignore")


def _parse_tounicode(cmap_bytes: bytes) -> tuple[dict[int, str], int]:
    """Parse a ToUnicode CMap stream (``beginbfchar``/``beginbfrange``
    sections) into ``(code -> text, code_byte_length)`` — the mapping
    Tika applies for CID-encoded PDFs (``Worker.java:198-212``)."""
    text = cmap_bytes.decode("latin-1", "replace")
    out: dict[int, str] = {}
    code_len = 2
    for m in re.finditer(r"begincodespacerange(.*?)endcodespacerange",
                         text, re.S):
        src = re.findall(r"<([0-9A-Fa-f]+)>", m.group(1))
        if src:
            code_len = max(1, len(src[0]) // 2)
    for m in re.finditer(r"beginbfchar(.*?)endbfchar", text, re.S):
        for src, dst in re.findall(
                r"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>", m.group(1)):
            out[int(src, 16)] = _utf16be_hex(dst)
            code_len = max(1, len(src) // 2)
    for m in re.finditer(r"beginbfrange(.*?)endbfrange", text, re.S):
        body = m.group(1)
        for lo, _hi, arr in re.findall(
                r"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*\[(.*?)\]",
                body, re.S):
            for k, dst in enumerate(re.findall(r"<([0-9A-Fa-f]+)>",
                                               arr)):
                out[int(lo, 16) + k] = _utf16be_hex(dst)
            code_len = max(1, len(lo) // 2)
        # strip WHOLE array-form entries first (<lo> <hi> [..] — not
        # just the bracket, which would leave an orphan <lo> <hi> pair
        # to mis-pair with the next entry): their [<dst> ...] bodies
        # would otherwise match the three-hex pattern and inject bogus
        # mappings that override legitimate bfchar entries
        flat = re.sub(r"<[0-9A-Fa-f]+>\s*<[0-9A-Fa-f]+>\s*\[.*?\]",
                      " ", body, flags=re.S)
        for lo, hi, dst in re.findall(
                r"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*"
                r"<([0-9A-Fa-f]+)>", flat):
            lo_i, hi_i = int(lo, 16), int(hi, 16)
            if hi_i - lo_i > 0xFFFF:
                continue   # malformed range; refuse to build 64k+ junk
            base = int(dst, 16)
            width = len(dst)
            for k in range(hi_i - lo_i + 1):
                out[lo_i + k] = _utf16be_hex(format(base + k,
                                                    f"0{width}x"))
            code_len = max(1, len(lo) // 2)
    return out, code_len


def _collect_tounicode(data: bytes, streams: list[bytes]
                       ) -> dict[int, dict[int, str]]:
    """Every ToUnicode CMap in the document, merged PER CODE WIDTH:
    ``{code_byte_length: {code: text}}``.

    Per-font tracking (following ``Tf`` operators) is what Tika does;
    merging same-width maps covers the dominant single-embedded-font
    case and disjoint CID spaces, and a collision merely swaps glyphs
    of the same document's fonts — acceptable for search-text
    extraction. Widths stay separate: letting a 1-byte simple-font
    CMap override the code length of a 2-byte CID font would split its
    show strings into bytes and decode wrong text."""
    merged: dict[int, dict[int, str]] = {}
    # streams referenced as "/ToUnicode N 0 R": resolve object N, else
    # fall back to any stream that contains CMap markers
    ref_objs = set(re.findall(rb"/ToUnicode\s+(\d+)\s+0\s+R", data))
    bodies: list[bytes] = []
    if ref_objs:
        for num in ref_objs:
            # anchor the object number: "2 0 obj" must not match inside
            # "12 0 obj"
            m = re.search(rb"(?<!\d)" + num + rb"\s+0\s+obj(.*?)endobj",
                          data, re.S)
            if m is not None:
                sm = re.search(rb"stream\r?\n(.*?)endstream",
                               m.group(1), re.S)
                if sm is not None:
                    bodies.append(sm.group(1))
    bodies.extend(s for s in streams if b"beginbfchar" in s
                  or b"beginbfrange" in s)
    import zlib
    seen: set[bytes] = set()
    for raw in bodies:
        # dedupe by CONTENT: the ref-resolved body and the marker-scan
        # fallback yield distinct bytes objects for the same stream
        if raw in seen:
            continue
        seen.add(raw)
        try:
            raw = zlib.decompress(raw)
        except Exception:
            pass
        if b"beginbfchar" not in raw and b"beginbfrange" not in raw:
            continue
        cmap, cl = _parse_tounicode(raw)
        if cmap:
            merged.setdefault(cl, {}).update(cmap)
    return merged


def _decode_cids(raw: bytes, cmaps: dict[int, dict[int, str]],
                 strict_single_byte: bool = False) -> str | None:
    """Decode show-string bytes as CID codes through the ToUnicode
    maps, trying each code width (widest first — a 2-byte string rarely
    decodes >=80% through a 1-byte map by accident, but prefer the
    stricter interpretation). Returns None unless enough codes map —
    emitting unmapped glyph ids would index noise. Literal-string
    callers pass ``strict_single_byte``: a subsetted simple font's
    PARTIAL 1-byte ToUnicode must not override a latin-1 string it only
    mostly covers (Tika tracks the active font per Tf;
    without that, full 1-byte coverage is the safe gate). Multi-byte
    maps keep the 80% threshold even for literal strings — their bytes
    cannot be latin-1 text, so a partial decode beats mojibake."""
    if not cmaps or not raw:
        return None
    for code_len in sorted(cmaps, reverse=True):
        cmap = cmaps[code_len]
        n = len(raw) // code_len
        if n == 0:
            continue
        codes = [int.from_bytes(raw[i * code_len:(i + 1) * code_len],
                                "big") for i in range(n)]
        hits = [cmap[c] for c in codes if c in cmap]
        need = (1.0 if (strict_single_byte and code_len == 1) else 0.8)
        if len(hits) >= max(1, int(need * n)):
            return "".join(hits)
    return None


def _extract_pdf(data: bytes) -> str:
    """PDF text pull: FlateDecode content streams, ``(...) Tj`` /
    ``[...] TJ`` literal strings, and CID/ToUnicode-encoded text —
    ``<hex> Tj`` show strings (and hex entries in TJ arrays) decoded
    through the document's ToUnicode CMaps, plus literal strings whose
    bytes map as CID codes. Exotic encodings with no ToUnicode data
    yield no text and are rejected by the caller rather than indexed
    as garbage (Tika-parity contract, ``Worker.java:198-212``)."""
    import zlib

    streams: list[bytes] = [
        m.group(1) for m in re.finditer(rb"stream\r?\n(.*?)endstream",
                                        data, re.S)]
    cmaps = _collect_tounicode(data, streams)

    def show(raw_bytes: bytes) -> str:
        # literal strings demand FULL 1-byte-CMap coverage before the
        # document CMap may override latin-1 (hex show-strings and
        # multi-byte maps keep the 80% threshold — their bytes cannot
        # be latin-1 text)
        cid = _decode_cids(raw_bytes, cmaps, strict_single_byte=True)
        if cid is not None:
            return cid
        return raw_bytes.decode("latin-1")

    texts: list[str] = []
    for raw in streams:
        try:
            raw = zlib.decompress(raw)
        except Exception:
            pass
        if b"beginbfchar" in raw or b"beginbfrange" in raw:
            continue   # a CMap stream, not page content
        for t in re.finditer(rb"\(((?:\\.|[^\\()])*)\)\s*Tj", raw, re.S):
            texts.append(show(_pdf_unescape_bytes(t.group(1))))
        for t in re.finditer(rb"<([0-9A-Fa-f\s]+)>\s*Tj", raw):
            h = re.sub(rb"\s", rb"", t.group(1)).decode()
            decoded = _decode_cids(
                bytes.fromhex(h if len(h) % 2 == 0 else h + "0"), cmaps)
            if decoded is not None:
                texts.append(decoded)
        for arr in re.finditer(rb"\[((?:\\.|<[^>]*>|[^\]])*)\]\s*TJ",
                               raw, re.S):
            body = arr.group(1)
            for t in re.finditer(rb"\(((?:\\.|[^\\()])*)\)", body, re.S):
                texts.append(show(_pdf_unescape_bytes(t.group(1))))
            for t in re.finditer(rb"<([0-9A-Fa-f\s]+)>", body):
                h = re.sub(rb"\s", rb"", t.group(1)).decode()
                decoded = _decode_cids(
                    bytes.fromhex(h if len(h) % 2 == 0 else h + "0"),
                    cmaps)
                if decoded is not None:
                    texts.append(decoded)
    return " ".join(texts)


def _extract_docx(z) -> str:
    """DOCX = zip + word/document.xml; text lives in ``<w:t>`` runs.
    ``z`` is the container already opened by :func:`extract_text`'s
    routing pass (one central-directory parse per document)."""
    import html

    with z.open("word/document.xml") as f:
        xml = f.read().decode("utf-8", "replace")
    parts = re.findall(r"<w:t[^>]*>(.*?)</w:t>", xml, re.S)
    return html.unescape(re.sub(r"<[^>]+>", " ", " ".join(parts)))


def _extract_pptx(z) -> str:
    """PPTX = zip + ``ppt/slides/slideN.xml`` (plus notes slides);
    visible text lives in DrawingML ``<a:t>`` runs — the same plain
    zip+XML walk as the DOCX path (Tika's OOXML parser analog)."""
    import html

    def order(name: str):
        # numeric slide order (slide2 before slide10 — a lexicographic
        # sort scrambles decks past 9 slides), slides before notes
        m = re.search(r"(\d+)\.xml$", name)
        return (name.startswith("ppt/notesSlides/"),
                int(m.group(1)) if m else 0, name)

    slides = sorted(
        (n for n in z.namelist()
         if re.fullmatch(r"ppt/(?:slides|notesSlides)/[^/]+\.xml", n)),
        key=order)
    parts: list[str] = []
    for n in slides:
        xml = z.read(n).decode("utf-8", "replace")
        parts.extend(re.findall(r"<a:t[^>]*>(.*?)</a:t>", xml, re.S))
    return html.unescape(re.sub(r"<[^>]+>", " ", " ".join(parts)))


def _extract_xlsx(z) -> str:
    """XLSX = zip + ``xl/sharedStrings.xml`` (the shared cell-string
    table, ``<t>`` runs) plus per-sheet inline strings (``<is><t>``).
    Numbers/formulas carry no searchable text and are skipped."""
    import html

    names = z.namelist()
    parts: list[str] = []
    if "xl/sharedStrings.xml" in names:
        xml = z.read("xl/sharedStrings.xml").decode("utf-8", "replace")
        parts.extend(re.findall(r"<t[^>]*>(.*?)</t>", xml, re.S))
    for n in sorted(n for n in names
                    if re.fullmatch(r"xl/worksheets/[^/]+\.xml", n)):
        xml = z.read(n).decode("utf-8", "replace")
        for blk in re.findall(r"<is>(.*?)</is>", xml, re.S):
            parts.extend(re.findall(r"<t[^>]*>(.*?)</t>", blk, re.S))
    return html.unescape(re.sub(r"<[^>]+>", " ", " ".join(parts)))


def _extract_odt(z) -> str:
    """OpenDocument Text = zip + ``content.xml``; body text lives in
    ``<text:p>``/``<text:span>`` runs (Tika's ODF parser analog)."""
    import html

    with z.open("content.xml") as f:
        xml = f.read().decode("utf-8", "replace")
    body = re.search(r"<office:body>(.*)</office:body>", xml, re.S)
    xml = body.group(1) if body is not None else xml
    # paragraph/tab/space elements carry whitespace semantics
    xml = re.sub(r"<text:(?:line-break|tab)[^>]*/?>", " ", xml)
    xml = re.sub(r"</text:[ph][^>]*>", "\n", xml)
    return html.unescape(re.sub(r"<[^>]+>", " ", xml))


# RTF control words with a direct text meaning
_RTF_SPECIAL = {"par": "\n", "line": "\n", "sect": "\n", "page": "\n",
                "tab": "\t", "emdash": "\u2014", "endash": "\u2013",
                "lquote": "\u2018", "rquote": "\u2019",
                "ldblquote": "\u201c", "rdblquote": "\u201d",
                "bullet": "\u2022", "emspace": " ", "enspace": " "}
# destination groups whose content is metadata/resources, not body text
_RTF_SKIP_DESTS = frozenset((
    "fonttbl", "colortbl", "stylesheet", "info", "pict", "object",
    "header", "footer", "headerl", "headerr", "footerl", "footerr",
    "ftnsep", "xe", "tc", "fldinst", "themedata", "datastore"))
_RTF_TOKEN = re.compile(
    r"\\([a-z]{1,32})(-?\d{1,10})? ?|\\'([0-9a-fA-F]{2})"
    r"|\\([^a-z])|([{}])|([^\\{}]+)", re.S)


def _rtf_strip_bin(text: str) -> str:
    """Remove ``\\binN`` runs WITH their N raw payload bytes before
    tokenizing: brace bytes inside a binary payload would otherwise
    corrupt the group stack (and the payload would index as noise)."""
    out: list[str] = []
    i = 0
    for m in re.finditer(r"\\bin(\d+) ?", text):
        if m.start() < i:
            continue   # a "\binN" inside another bin's payload
        out.append(text[i:m.start()])
        i = m.end() + int(m.group(1))
    out.append(text[i:])
    return "".join(out)


def _extract_rtf(data: bytes) -> str:
    """Minimal RTF body-text pull (Tika's RTFParser analog): walks the
    group tree, drops resource/metadata destinations and ``\\binN``
    payloads, honors ``\\uN`` unicode escapes (surrogate pairs
    combined, lone surrogates dropped), ``\\'xx`` cp1252 bytes, and
    paragraph controls."""
    text = _rtf_strip_bin(data.decode("latin-1", "replace"))
    out: list[str] = []
    stack: list[int] = []
    skip = 0
    uc_skip = 0   # chars to swallow after \uN (the ANSI fallback)
    for m in _RTF_TOKEN.finditer(text):
        word, arg, hexb, esc, brace, plain = m.groups()
        if brace == "{":
            stack.append(skip)
            continue
        if brace == "}":
            skip = stack.pop() if stack else 0
            uc_skip = 0   # a fallback never spans a group boundary
            continue
        if esc is not None:
            if esc == "*":        # \* introduces an optional destination
                skip = 1
            elif not skip and esc in "\\{}":
                out.append(esc)
            elif not skip and esc == "~":
                out.append("\u00a0")
            continue
        if hexb is not None:
            if uc_skip:
                uc_skip -= 1
            elif not skip:
                out.append(bytes([int(hexb, 16)])
                           .decode("cp1252", "replace"))
            continue
        if word is not None:
            if word in _RTF_SKIP_DESTS:
                skip = 1
            elif word == "u" and arg is not None:
                # only arm the fallback-swallow OUTSIDE skipped groups:
                # a skipped group's fallback char is skipped with the
                # group, and a leaked uc_skip would eat the first body
                # character after it
                if not skip:
                    out.append(chr(int(arg) & 0xFFFF))
                    uc_skip = 1
            elif word in _RTF_SPECIAL and not skip:
                out.append(_RTF_SPECIAL[word])
            continue
        if plain and not skip:
            if uc_skip:
                plain = plain[uc_skip:]
                uc_skip = 0
            out.append(plain)
    joined = "".join(out).replace("\r\n", "\n")
    # \uN surrogate-pair escapes (Word writes non-BMP chars this way):
    # the utf-16 round trip combines adjacent pairs into real astral
    # chars and drops lone surrogates, which cannot be UTF-8 encoded
    # and would crash any downstream serialization
    return (joined.encode("utf-16-le", "surrogatepass")
            .decode("utf-16-le", "ignore"))


def _cfb_streams(data: bytes) -> dict[str, bytes]:
    """Minimal [MS-CFB] (OLE2 compound file) reader: returns the
    top-level stream name -> bytes map. Supports the regular FAT chain,
    the DIFAT extension, and the mini stream (streams under the 4096-
    byte cutoff live in 64-byte mini sectors inside the root entry's
    chain) — the containers Word 97-2003 actually produces."""
    import struct as st

    if data[:8] != b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1":
        raise ValueError("not an OLE2 compound file")
    sec_shift = st.unpack_from("<H", data, 30)[0]
    mini_shift = st.unpack_from("<H", data, 32)[0]
    sec = 1 << sec_shift
    mini_sec = 1 << mini_shift
    n_fat = st.unpack_from("<I", data, 44)[0]
    dir_start = st.unpack_from("<I", data, 48)[0]
    mini_cutoff = st.unpack_from("<I", data, 56)[0]
    minifat_start = st.unpack_from("<I", data, 60)[0]
    difat_start = st.unpack_from("<I", data, 68)[0]
    n_difat = st.unpack_from("<I", data, 72)[0]

    def sector(i: int) -> bytes:
        off = (i + 1) * sec
        return data[off:off + sec]

    # FAT sector list: 109 header DIFAT entries + chained DIFAT sectors
    fat_sectors = list(st.unpack_from("<109I", data, 76))
    s = difat_start
    for _ in range(n_difat):
        if s in (0xFFFFFFFE, 0xFFFFFFFF):
            break
        blk = sector(s)
        more = st.unpack(f"<{sec // 4}I", blk)
        fat_sectors.extend(more[:-1])
        s = more[-1]
    fat_sectors = [x for x in fat_sectors[:max(n_fat, 0) or None]
                   if x not in (0xFFFFFFFE, 0xFFFFFFFF)]
    fat: list[int] = []
    for fs in fat_sectors:
        fat.extend(st.unpack(f"<{sec // 4}I", sector(fs)))

    def chain(start: int) -> bytes:
        out, s, seen = [], start, set()
        while s not in (0xFFFFFFFE, 0xFFFFFFFF) and s < len(fat):
            if s in seen:
                break   # corrupt cycle; stop rather than loop forever
            seen.add(s)
            out.append(sector(s))
            s = fat[s]
        return b"".join(out)

    directory = chain(dir_start)
    # mini FAT + the mini stream (root entry's chain)
    minifat: list[int] = []
    if minifat_start not in (0xFFFFFFFE, 0xFFFFFFFF):
        mf = chain(minifat_start)
        minifat = list(st.unpack(f"<{len(mf) // 4}I", mf))
    root_start = st.unpack_from("<I", directory, 116)[0]
    mini_data = chain(root_start)

    def mini_chain(start: int) -> bytes:
        out, s, seen = [], start, set()
        while s not in (0xFFFFFFFE, 0xFFFFFFFF) and s < len(minifat):
            if s in seen:
                break
            seen.add(s)
            out.append(mini_data[s * mini_sec:(s + 1) * mini_sec])
            s = minifat[s]
        return b"".join(out)

    # walk only the ROOT storage's child tree: a sub-storage (e.g. an
    # embedded OLE object in ObjectPool) may contain its own
    # WordDocument/1Table pair, and a flat scan would let it shadow the
    # actual document body
    n_entries = len(directory) // 128

    def entry_at(i: int) -> bytes:
        return directory[i * 128:(i + 1) * 128]

    streams: dict[str, bytes] = {}
    root_child = st.unpack_from("<i", entry_at(0), 76)[0]
    stack = [root_child]
    seen_ids: set[int] = set()
    while stack:
        i = stack.pop()
        if i < 0 or i >= n_entries or i in seen_ids:
            continue
        seen_ids.add(i)
        entry = entry_at(i)
        stack.append(st.unpack_from("<i", entry, 68)[0])   # left sib
        stack.append(st.unpack_from("<i", entry, 72)[0])   # right sib
        name_len = st.unpack_from("<H", entry, 64)[0]
        etype = entry[66]
        if etype != 2 or name_len < 2:   # root-level streams only;
            continue                     # storages are NOT descended
        name = entry[:name_len - 2].decode("utf-16-le", "ignore")
        start = st.unpack_from("<I", entry, 116)[0]
        size = st.unpack_from("<Q", entry, 120)[0]
        raw = (mini_chain(start) if size < mini_cutoff
               else chain(start))
        streams[name] = raw[:size]
    return streams


def _extract_doc(data: bytes) -> str:
    """Legacy Word 97-2003 ``.doc`` text ([MS-DOC]): locate the piece
    table (CLX) in the Table stream via the FIB, then pull each piece's
    text from the WordDocument stream — cp1252 for compressed pieces,
    UTF-16LE otherwise. The last common Tika format the reference's
    ``AutoDetectParser`` handles (``Worker.java:198-212``) that
    previously 415'd here."""
    streams = _cfb_streams(data)
    word = streams.get("WordDocument")
    if word is None or len(word) < 0x200:
        raise UnsupportedMediaType("OLE2 container without a "
                                   "WordDocument stream")
    import struct as st
    if st.unpack_from("<H", word, 0)[0] != 0xA5EC:
        raise UnsupportedMediaType("WordDocument stream without FIB")
    flags = st.unpack_from("<H", word, 0x000A)[0]
    if flags & 0x0100:   # fEncrypted: piece text is RC4/XOR ciphertext
        raise UnsupportedMediaType("encrypted .doc")
    table = streams.get("1Table" if flags & 0x0200 else "0Table")
    if table is None:
        table = streams.get("1Table") or streams.get("0Table")
    fc_clx = st.unpack_from("<I", word, 0x01A2)[0]
    lcb_clx = st.unpack_from("<I", word, 0x01A6)[0]
    if table is None or lcb_clx == 0 or fc_clx + lcb_clx > len(table):
        raise UnsupportedMediaType(".doc without a readable piece table")
    clx = table[fc_clx:fc_clx + lcb_clx]
    pos = 0
    while pos < len(clx) and clx[pos] == 0x01:   # Prc (grpprl) blocks
        cb = st.unpack_from("<H", clx, pos + 1)[0]
        pos += 3 + cb
    if pos >= len(clx) or clx[pos] != 0x02:
        raise UnsupportedMediaType(".doc piece table not found in CLX")
    lcb = st.unpack_from("<I", clx, pos + 1)[0]
    plc = clx[pos + 5:pos + 5 + lcb]
    n = (len(plc) - 4) // 12
    if n <= 0:
        raise UnsupportedMediaType(".doc with an empty piece table")
    cps = st.unpack(f"<{n + 1}I", plc[:4 * (n + 1)])
    out: list[str] = []
    for i in range(n):
        pcd = plc[4 * (n + 1) + 8 * i:4 * (n + 1) + 8 * (i + 1)]
        fc = st.unpack_from("<I", pcd, 2)[0]
        n_cp = cps[i + 1] - cps[i]
        if fc & 0x40000000:   # compressed: cp1252, one byte per cp
            off = (fc & 0x3FFFFFFF) // 2
            out.append(word[off:off + n_cp].decode("cp1252", "replace"))
        else:
            off = fc & 0x3FFFFFFF
            out.append(word[off:off + 2 * n_cp]
                       .decode("utf-16-le", "replace"))
    text = "".join(out)
    # Word control characters: paragraph/cell marks, field delimiters
    text = (text.replace("\r", "\n").replace("\x07", "\n")
            .replace("\x0b", "\n"))
    return re.sub(r"[\x00-\x08\x0c-\x1f\x13\x14\x15]", " ", text)


def _extract_html(text: str) -> str:
    """Strip tags/scripts/styles, unescape entities."""
    import html

    text = re.sub(r"(?is)<(script|style)\b.*?</\1\s*>", " ", text)
    text = re.sub(r"(?s)<!--.*?-->", " ", text)
    text = re.sub(r"(?s)<[^>]+>", " ", text)
    return html.unescape(text)


_BINARY_MAGICS = (b"\x7fELF", b"\x89PNG", b"\xff\xd8\xff", b"GIF8",
                  b"\x1f\x8b", b"MZ", b"\x00asm", b"OggS", b"fLaC",
                  b"\xca\xfe\xba\xbe")


def extract_text(data: bytes) -> str:
    """Bytes -> searchable text, the Tika-parity dispatch.

    Known document formats are extracted (PDF including CID/ToUnicode
    text, DOCX, PPTX, XLSX, ODT, RTF, HTML); plain text goes through
    charset
    fallback (UTF-8 strict first, like ``Files.readString``, then BOM'd
    UTF-16, then Latin-1); recognized binaries, undecodable blobs, and
    text-free documents raise :class:`UnsupportedMediaType` instead of
    entering the index as noise.
    """
    if data[:5] == b"%PDF-":
        text = _extract_pdf(data)
        if not text.strip():
            raise UnsupportedMediaType(
                "PDF with no extractable text (unsupported encoding)")
        return text
    if data[:5] == b"{\\rtf":
        text = _extract_rtf(data)
        if not text.strip():
            raise UnsupportedMediaType("RTF with no extractable text")
        return text
    if data[:8] == b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1":
        # OLE2 compound file: Word 97-2003 .doc extracts; other OLE2
        # payloads (.xls/.ppt/.msg) refuse with a typed 415
        try:
            text = _extract_doc(data)
        except UnsupportedMediaType:
            raise
        except Exception as e:
            raise UnsupportedMediaType(
                f"unreadable OLE2 document ({type(e).__name__})")
        if not text.strip():
            raise UnsupportedMediaType(".doc with no extractable text")
        return text
    if data[:4] == b"PK\x03\x04":
        import io
        import zipfile

        try:
            zf = zipfile.ZipFile(io.BytesIO(data))
        except Exception:
            raise UnsupportedMediaType("unreadable zip container")
        # route by the container's member layout (what Tika's container
        # detector does) instead of try/except chaining extractors; the
        # ONE opened ZipFile (one central-directory parse) is handed to
        # the extractor
        with zf as z:
            names = set(z.namelist())
            if "word/document.xml" in names:
                extractor = _extract_docx
            elif any(n.startswith("ppt/slides/") for n in names):
                extractor = _extract_pptx
            elif "xl/workbook.xml" in names:
                extractor = _extract_xlsx
            elif "content.xml" in names:
                extractor = _extract_odt
            else:
                raise UnsupportedMediaType(
                    "zip container without a known document body "
                    "(word/document.xml, ppt/slides/, xl/workbook.xml, "
                    "or ODF content.xml)")
            try:
                text = extractor(z)
            except UnsupportedMediaType:
                raise
            except Exception as e:
                raise UnsupportedMediaType(
                    f"unreadable document container ({type(e).__name__})")
        if not text.strip():
            raise UnsupportedMediaType(
                "document container with no extractable text")
        return text
    for magic in _BINARY_MAGICS:
        if data[:len(magic)] == magic:
            raise UnsupportedMediaType(
                f"binary format (magic {magic!r})")
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError:
        text = None
    if text is None and data[:2] in (b"\xff\xfe", b"\xfe\xff"):
        try:
            text = data.decode("utf-16")
        except UnicodeDecodeError:
            text = None
    if text is None:
        text = data.decode("latin-1")
    # a blob that is substantially control characters (or U+FFFD from a
    # lossy client-side decode) is binary, not text — reject it rather
    # than index noise. This guards EVERY decode branch: NUL-padded
    # archives are valid UTF-8, so checking only the fallback path would
    # let them through (tar's magic sits at offset 257, past any magic
    # list).
    sample = text[:4096]
    n_ctrl = sum(1 for ch in sample
                 if (ch < "\t") or ("\r" < ch < " ") or ch == "\x7f"
                 or ch == "�")
    if sample and n_ctrl / len(sample) > 0.10:
        raise UnsupportedMediaType(
            "text with high control-character density (binary content)")
    text = "".join(
        ch if ch in "\t\n\r"
        or not unicodedata.category(ch).startswith("C") else " "
        for ch in text)
    # HTML only when the document STARTS as HTML — a plain-text file
    # merely mentioning "<html" must not get its angle brackets stripped
    head = text[:512].lstrip("﻿ \t\r\n").lower()
    if head.startswith("<!doctype html") or head.startswith("<html"):
        return _extract_html(text)
    return text


