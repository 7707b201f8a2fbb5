"""NCHW building blocks with the reference's torch parameter names."""
