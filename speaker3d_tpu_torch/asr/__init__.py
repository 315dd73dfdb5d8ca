"""ASR: the SAN-M encoder with a CTC head, greedy decoding with timestamps."""
