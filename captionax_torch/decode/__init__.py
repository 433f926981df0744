"""Decoding: the plain greedy, sampling and beam oracles and the serving front end."""
