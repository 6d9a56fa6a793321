"""Data: synthetic corpora, the byte tokenizer, sequence packing and the
WARC → token training loader."""
