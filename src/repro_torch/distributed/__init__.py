"""Host-side fault supervision (`fault`): the engine's array-loss
supervisor and straggler monitor."""
