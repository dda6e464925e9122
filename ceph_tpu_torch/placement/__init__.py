"""CRUSH placement: the map model (the mappers come with a later slice)."""
