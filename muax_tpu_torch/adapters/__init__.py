"""Framework adapters (reference: muax/frameworks/*)."""
