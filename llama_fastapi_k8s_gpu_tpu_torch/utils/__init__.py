"""Settings, health state and device resolution."""
