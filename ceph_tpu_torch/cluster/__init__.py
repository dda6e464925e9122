"""Cluster layer: the OSDMap, the cluster simulator and its host
substrate, the EC data-plane engine, the device staging tier and the
durable BlueStore (block device, KV and WAL)."""
