"""The traffic generator and the traffic mixes (one JSON file each)."""
