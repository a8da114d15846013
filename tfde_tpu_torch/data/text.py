"""Raw text -> packed LM training batches — counterpart of
`tfde_tpu/data/text.py`: read text files, tokenize offline, pack with
`data/packing.py`, and stream fixed-shape (tokens, segment_ids) batches
for `packing.packed_next_token_loss`.

The tokenizer is duck-typed (`tokenizer(text, add_special_tokens=False)
["input_ids"]` and `eos_token_id`); `load_tokenizer` reads one from a
local `save_pretrained` directory with transformers, imported only when
it is called, and never downloads.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tfde_tpu_torch.data.packing import pack_documents
from tfde_tpu_torch.data.pipeline import Dataset


def load_tokenizer(tokenizer_dir: str):
    """An AutoTokenizer from a local save_pretrained() directory."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(tokenizer_dir,
                                         local_files_only=True)


def read_documents(paths: Sequence[str],
                   split: str = "paragraph") -> List[str]:
    """Text files -> document strings. split: 'paragraph' (blank-line
    separated), 'line' or 'file'. Empty documents are dropped."""
    docs: List[str] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            content = f.read()
        if split == "file":
            parts = [content]
        elif split == "line":
            parts = content.splitlines()
        elif split == "paragraph":
            parts = content.split("\n\n")
        else:
            raise ValueError(f"split must be 'paragraph', 'line' or 'file', "
                             f"got {split!r}")
        docs.extend(p.strip() for p in parts if p.strip())
    return docs


def tokenize_documents(docs: Sequence[str], tokenizer,
                       append_eos: bool = True,
                       vocab_limit: Optional[int] = None
                       ) -> List[np.ndarray]:
    """Documents -> int32 token arrays, each ended by the tokenizer's eos
    under `append_eos` (packed documents sit back to back, and the model
    should learn where one ends). `vocab_limit` (the model's vocab) makes
    a tokenizer that does not match the model fail here."""
    eos = None
    if append_eos:
        eos = tokenizer.eos_token_id
        if eos is None:
            raise ValueError(
                "append_eos=True but the tokenizer has no eos_token; pass "
                "append_eos=False to pack without terminators")
    out: List[np.ndarray] = []
    for d in docs:
        ids = list(tokenizer(d, add_special_tokens=False)["input_ids"])
        if eos is not None:
            ids.append(eos)
        if not ids:
            continue
        arr = np.asarray(ids, np.int32)
        if vocab_limit is not None and arr.max() >= vocab_limit:
            raise ValueError(
                f"token id {int(arr.max())} >= model vocab {vocab_limit}: "
                f"tokenizer and model do not match")
        out.append(arr)
    return out


def packed_text_batches(paths: Sequence[str], tokenizer, seq_len: int,
                        batch_size: int, split: str = "paragraph",
                        append_eos: bool = True,
                        vocab_limit: Optional[int] = None, seed: int = 0
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Read -> tokenize -> pack once, then yield shuffled (tokens [B, S],
    segment_ids [B, S]) batches forever: rows reshuffled each epoch, the
    last partial batch of an epoch dropped. A corpus of fewer rows than a
    batch is tiled up to one."""
    docs = read_documents(paths, split=split)
    if not docs:
        raise ValueError(f"no documents found in {list(paths)!r}")
    token_docs = tokenize_documents(docs, tokenizer, append_eos=append_eos,
                                    vocab_limit=vocab_limit)
    tokens, seg = pack_documents(token_docs, seq_len)
    if len(tokens) < batch_size:
        reps = -(-batch_size // len(tokens))
        tokens = np.tile(tokens, (reps, 1))
        seg = np.tile(seg, (reps, 1))
    ds = (Dataset.from_tensor_slices((tokens, seg))
          .shuffle(len(tokens), seed=seed)
          .repeat()
          .batch(batch_size, drop_remainder=True))
    yield from iter(ds)
