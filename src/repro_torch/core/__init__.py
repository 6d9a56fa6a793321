"""Host-side WARC processing (streams, records, parser)."""
