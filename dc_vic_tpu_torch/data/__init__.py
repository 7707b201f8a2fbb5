"""Image datasets and the threaded host loader of the trainer."""
