"""DFP arithmetic, bit packing, cluster ternarization and the precision
policy (counterpart of ``repro/core``)."""
