"""Image quality metrics, and the perceptual networks' loader."""
