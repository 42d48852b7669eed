"""Alias package of the dataset fetchers and generators, as the original
library's ``spotlight.datasets`` path names them."""
