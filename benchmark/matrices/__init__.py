"""Matrix builders, found by the name a configuration gives."""
