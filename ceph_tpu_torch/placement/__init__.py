"""CRUSH placement: the map model, the builder, the scalar mapper and the
batched mappers on the card (xla_mapper, fast_mapper)."""
