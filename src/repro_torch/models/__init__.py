"""The evaluation networks."""
