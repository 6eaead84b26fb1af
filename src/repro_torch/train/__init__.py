"""Serving: the packed-inference server over the port's forwards."""
