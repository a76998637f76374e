class Plane:
    def ok(self, w, body, remaining):
        return self._scatter.post(
            w, "/worker/process-batch", body,
            headers={"X-Deadline-Ms": str(remaining)})

    def undeadlined(self, w, body):
        return self._scatter.post(w, "/worker/process-batch", body)
