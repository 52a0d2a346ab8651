"""Host-side audio and video IO."""
