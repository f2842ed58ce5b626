"""The CLIP BPE tokenizer."""
