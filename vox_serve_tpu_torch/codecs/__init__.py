"""Audio codecs of the port (so far: the Qwen3-TTS-Tokenizer-12Hz decoder)."""
