"""Drivers of the port's LM substrate (serving)."""
