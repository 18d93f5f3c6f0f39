"""Token data sources and the asymmetric batch layout."""
