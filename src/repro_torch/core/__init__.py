"""Geostatistics core: Matérn covariance, likelihoods and the TLR path."""
