"""Decoding: the plain beam search oracle and the serving front end."""
