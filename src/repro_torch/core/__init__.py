"""Offline weight pairing, the op ledger and the conv pairing artifacts."""
