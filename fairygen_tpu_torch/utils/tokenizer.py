"""Tokenizer wrappers (port of fairygen_tpu/utils/tokenizer.py).

``HuggingfaceTokenizer`` is the UMT5 path's wrapper: whitespace / lower /
canonicalize cleaning, then ids and masks padded and truncated to
``seq_len`` (512 for Wan), as numpy int arrays.  ``CLIPTokenizerWrapper``
is SDXL's (CLIP-L and OpenCLIP bigG): CLIP BPE ids padded to the maximum
length and truncated at 77.  ``transformers`` is imported when a tokenizer
is constructed, so the module imports without it; a tokenizer asked for
without it raises ``ImportError``.
"""
from __future__ import annotations

import html
import re
import string
from typing import Optional


def basic_clean(text: str) -> str:
    try:
        import ftfy
    except ImportError:  # ftfy is optional upstream too: the text stays as it is
        ftfy = None
    if ftfy is not None:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize(text: str, keep_punctuation_exact_string: Optional[str] = None) -> str:
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(str.maketrans("", "", string.punctuation))
            for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


class HuggingfaceTokenizer:
    def __init__(self, name: str, seq_len: Optional[int] = None, clean: Optional[str] = None,
                 **kwargs):
        if clean not in (None, "whitespace", "lower", "canonicalize"):
            raise ValueError(f"clean must be None, 'whitespace', 'lower' or 'canonicalize', "
                             f"got {clean!r}")
        from transformers import AutoTokenizer

        self.name = name
        self.seq_len = seq_len
        self.clean = clean
        self.tokenizer = AutoTokenizer.from_pretrained(name, **kwargs)
        self.vocab_size = self.tokenizer.vocab_size

    def _clean(self, text):
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text

    def __call__(self, sequence, return_mask: bool = False, **kwargs):
        _kwargs = {"return_tensors": "np"}
        if self.seq_len is not None:
            _kwargs.update(padding="max_length", truncation=True, max_length=self.seq_len)
        _kwargs.update(kwargs)
        if isinstance(sequence, str):
            sequence = [sequence]
        if self.clean:
            sequence = [self._clean(u) for u in sequence]
        ids = self.tokenizer(sequence, **_kwargs)
        if return_mask:
            return ids.input_ids, ids.attention_mask
        return ids.input_ids


class CLIPTokenizerWrapper:
    """77-token CLIP tokenizer (SDXL's two text encoders): a string or a
    list of strings -> (B, 77) numpy int ids."""

    def __init__(self, name: str, **kwargs):
        from transformers import CLIPTokenizer

        self.tokenizer = CLIPTokenizer.from_pretrained(name, **kwargs)

    def __call__(self, text):
        out = self.tokenizer([text] if isinstance(text, str) else text, padding="max_length",
                             truncation=True, max_length=77, return_tensors="np")
        return out.input_ids
