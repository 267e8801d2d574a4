"""The OpenAI CLIP BPE tokenizer (port of ``vtp_tpu/tokenizers``)."""

from vtp_tpu_torch.tokenizers.bpe import SimpleTokenizer, find_bpe_vocab, get_tokenizer

__all__ = ["SimpleTokenizer", "find_bpe_vocab", "get_tokenizer"]
