"""Datasets and batch loaders for the trainer."""
