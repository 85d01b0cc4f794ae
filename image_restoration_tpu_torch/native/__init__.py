"""Host-side native code: the `.pak` reader (`pakio`), built at first use."""
