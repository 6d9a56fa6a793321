"""Column codec (array packing shared with the CDX index format)."""
