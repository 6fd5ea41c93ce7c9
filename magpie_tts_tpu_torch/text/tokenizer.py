"""IPA phoneme tokenizer.

Pipeline semantics match the reference (src/magpie.cpp:404-495):
BOS, normalize + ASCII-lowercase, surround sentence punctuation with spaces,
then per word: single-char vocab hit -> token; dictionary word -> greedy
longest-match (<= 4 bytes) of its IPA string into vocab ids, skipping unknown
bytes; OOV word -> per-character uppercase char tokens; words separated by the
space token; trailing space dropped; EOS.

Vocab and pronunciation dictionary are carried in GGUF metadata
(``magpie.tokenizer.vocab`` newline-separated, ``magpie.tokenizer.dict`` TSV).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

from .normalize import normalize_text

_PUNCT = {",", ".", "!", "?", ":", ";"}
_MAX_MATCH_BYTES = 4


class MagpieTokenizer:
    def __init__(
        self,
        vocab: List[str],
        pron_dict: Optional[Dict[str, str]] = None,
        pad_id: int = 94,
        oov_id: int = 95,
        space_id: int = 93,
        bos_id: int = 2378,
        eos_id: int = 2379,
    ):
        self.vocab = vocab
        self.token_to_id = {tok: i for i, tok in enumerate(vocab)}
        self.dict = pron_dict or {}
        self.pad_id = pad_id
        self.oov_id = oov_id
        self.space_id = space_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        # Greedy matching operates on UTF-8 bytes (multi-byte IPA chars): precompute
        # a byte-keyed view of the vocab for exact parity with byte-wise matching.
        self._byte_vocab = {tok.encode("utf-8"): i for tok, i in self.token_to_id.items()}

    @classmethod
    def from_gguf_metadata(cls, kv: Mapping[str, object]) -> "MagpieTokenizer":
        vocab_str = kv.get("magpie.tokenizer.vocab")
        if not isinstance(vocab_str, str):
            raise ValueError("magpie.tokenizer.vocab missing from GGUF metadata")
        vocab = vocab_str.split("\n")
        pron: Dict[str, str] = {}
        dict_str = kv.get("magpie.tokenizer.dict")
        if isinstance(dict_str, str):
            for line in dict_str.split("\n"):
                word, tab, ipa = line.partition("\t")
                if tab:
                    pron[word] = ipa
        return cls(
            vocab,
            pron,
            pad_id=int(kv.get("magpie.tokenizer.pad", 94)),
            oov_id=int(kv.get("magpie.tokenizer.oov", 95)),
            space_id=int(kv.get("magpie.tokenizer.space", 93)),
            bos_id=int(kv.get("magpie.text_bos_id", 2378)),
            eos_id=int(kv.get("magpie.text_eos_id", 2379)),
        )

    def _match_ipa(self, pron: str) -> List[int]:
        """Greedy longest-match of an IPA string into vocab ids, byte-wise."""
        ids: List[int] = []
        data = pron.encode("utf-8")
        i = 0
        while i < len(data):
            for length in range(min(len(data) - i, _MAX_MATCH_BYTES), 0, -1):
                tok_id = self._byte_vocab.get(data[i:i + length])
                if tok_id is not None:
                    ids.append(tok_id)
                    i += length
                    break
            else:
                i += 1  # unknown byte: skip
        return ids

    def encode(self, text: str) -> List[int]:
        tokens = [self.bos_id]

        normalized = _ascii_lower(normalize_text(text))
        spaced = "".join(f" {c} " if c in _PUNCT else c for c in normalized)

        emitted_any = False
        for word in spaced.split(" "):
            if not word:
                continue
            # Byte semantics throughout, exactly as the reference (which operates
            # on std::string bytes, magpie.cpp:437-477): the single-char fast path
            # requires a single BYTE (a multi-byte IPA char typed directly does
            # NOT hit it), and the OOV fallback walks bytes, so non-ASCII bytes
            # (never a valid standalone UTF-8 vocab key) are dropped.
            word_bytes = word.encode("utf-8")
            if len(word_bytes) == 1 and word in self.token_to_id:
                tokens.append(self.token_to_id[word])
            elif word in self.dict:
                tokens.extend(self._match_ipa(self.dict[word]))
            else:
                for b in word_bytes:
                    upper = b - 0x20 if 0x61 <= b <= 0x7A else b
                    tok_id = self._byte_vocab.get(bytes([upper]))
                    if tok_id is not None:
                        tokens.append(tok_id)
            tokens.append(self.space_id)
            emitted_any = True

        if emitted_any and tokens[-1] == self.space_id:
            tokens.pop()
        tokens.append(self.eos_id)
        return tokens


def _ascii_lower(text: str) -> str:
    """ASCII-only lowercasing (multi-byte chars untouched, unlike str.lower())."""
    return "".join(chr(ord(c) + 32) if "A" <= c <= "Z" else c for c in text)


def chunk_token_ids(token_ids: List[int], max_len: int, split_id: int,
                    bos_id: int, eos_id: int) -> List[List[int]]:
    """Split one tokenized utterance into <=``max_len`` chunks at inter-word
    space-token boundaries, re-wrapping each chunk with BOS/EOS.

    The intra-sentence analog of sentence chunking for inputs longer than the
    largest compiled bucket: the reference sizes graphs per enc_seq so any
    length runs (magpie.cpp:2284-2374); NeMo's own longform strategy is
    text-level chunking (reference docs/MAGPIE_INFERENCE_FINDINGS.md:206-212).
    A chunk with no space token inside the budget is hard-cut (e.g. one
    gigantic OOV word) — still synthesizes, never raises.
    """
    ids = list(token_ids)
    if len(ids) <= max_len:
        return [ids]
    if max_len < 4:
        raise ValueError(f"max_len {max_len} too small to chunk")
    body = ids[1:] if ids and ids[0] == bos_id else ids
    if body and body[-1] == eos_id:
        body = body[:-1]
    budget = max_len - 2  # room for the BOS/EOS wrap
    chunks: List[List[int]] = []
    start = 0
    while start < len(body):
        end = min(start + budget, len(body))
        if end < len(body):
            # Cut at the LAST space inside the window (the space is dropped —
            # it only separated the words now split across chunks).
            cut = -1
            for j in range(end - 1, start, -1):
                if body[j] == split_id:
                    cut = j
                    break
            if cut > start:
                chunks.append([bos_id] + body[start:cut] + [eos_id])
                start = cut + 1
                continue
        chunks.append([bos_id] + body[start:end] + [eos_id])
        start = end
    return [c for c in chunks if len(c) > 2]
