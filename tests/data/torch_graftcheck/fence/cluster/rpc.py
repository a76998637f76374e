class Leader:
    def good(self, w, http_post):
        http_post(w + "/worker/delete", b"{}",
                  headers=self._epoch_headers())

    def bad(self, w, http_post):
        http_post(w + "/worker/delete", b"{}",
                  headers={"Content-Type": "application/json"})

    def bad_upload(self, w, http_post):
        http_post(w + "/worker/upload?name=a", b"data")
