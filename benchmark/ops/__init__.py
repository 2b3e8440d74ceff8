"""Request loops, found by the ``op`` a traffic file names."""
