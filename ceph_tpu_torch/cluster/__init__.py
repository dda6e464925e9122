"""Cluster layer: the EC data-plane engine and the device staging tier."""
