"""AdamW with fp32, bf16 or blockwise int8 moments."""
