"""BERT's uncased tokenizer for GroundingDINO's prompts, without ``tokenizers``.

The basic tokenizer (control characters dropped, whitespace split, CJK
characters isolated, lowercase, accents stripped, punctuation split off)
followed by greedy longest-match WordPiece over a ``vocab.txt`` or a list,
as ``BertTokenizerFast`` with its defaults. ``GroundingDinoProcessor`` first
merges a list of labels into ``"label one. label two."``
(``processing_grounding_dino.py:75-81``); ``encode`` adds [CLS]/[SEP] and
returns ``input_ids``, ``attention_mask`` and ``token_type_ids``. Like the
processor it does not truncate: GroundingDINO cuts the text at
``max_text_len`` itself, so a long prompt gives ``transformers``' result.
"""

from __future__ import annotations

import unicodedata


def merge_labels(labels) -> str:
    """``["A cat", "a dog"]`` → ``"a cat. a dog."``; a string already merged
    (or any label holding a ".") passes through as the processor's does."""
    if isinstance(labels, str):
        return labels
    labels = list(labels)
    if not all(isinstance(t, str) and "." not in t for t in labels):
        raise ValueError("labels are a list of strings without '.' or one merged string")
    return ". ".join(t.strip().lower() for t in labels) + "."


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_tokenize(text: str) -> list[str]:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = []
    for word in "".join(out).split():
        word = unicodedata.normalize("NFD", word.lower())
        word = "".join(c for c in word if unicodedata.category(c) != "Mn")
        current = ""
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    words.append(current)
                words.append(ch)
                current = ""
            else:
                current += ch
        if current:
            words.append(current)
    return words


class WordPieceTokenizer:
    def __init__(self, vocab, unk_token: str = "[UNK]", max_input_chars_per_word: int = 100):
        """``vocab``: a list of tokens (its order gives the ids) or the path
        of a ``vocab.txt``, one token a line."""
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as f:
                vocab = [line.rstrip("\n") for line in f]
        self.vocab = {tok: i for i, tok in enumerate(vocab)}
        for tok in ("[CLS]", "[SEP]", unk_token):
            if tok not in self.vocab:
                raise ValueError(f"the vocabulary has no {tok}")
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end, piece = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        return [p for word in basic_tokenize(text) for p in self.wordpiece(word)]

    def encode(self, text) -> dict[str, list[int]]:
        """``text``: a string or a list of labels (merged first). Returns
        ``input_ids`` ([CLS] … [SEP]), ``attention_mask`` and
        ``token_type_ids``, uncut, as the processor's; the model cuts them
        at ``max_text_len`` (``GroundingDinoModel.text_features``)."""
        ids = [self.vocab[t] for t in self.tokenize(merge_labels(text))]
        ids = [self.vocab["[CLS]"], *ids, self.vocab["[SEP]"]]
        return {"input_ids": ids, "attention_mask": [1] * len(ids),
                "token_type_ids": [0] * len(ids)}
