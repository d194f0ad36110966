"""pFedSOP math and the FL-method adapters."""
