"""Binarization primitives and packed layers."""
