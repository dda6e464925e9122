"""Cluster layer: the OSDMap, the cluster simulator and its host
substrate, the EC data-plane engine and the device staging tier."""
